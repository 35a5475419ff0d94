"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (the 1-bit-Adam-family trick, applied at
the data-parallel boundary).

The port of ``repro.train.compression``, in the same arithmetic (the
quantized codes are the reference's, bit for bit). ``compressed_psum``
is the reduction itself. The reference calls it inside ``shard_map`` with
each rank's own gradient and reduces over the mesh axis ``axis_name``;
the port runs on one card, where the ranks of a ``VirtualMesh`` axis are
a leading tensor dimension (as ``models.moe.moe_ffn_ep`` holds them):
``g[r]`` and ``err[r]`` are rank r's gradient and residual. The
residual carried into the next step re-injects the quantization error,
so the *accumulated* update is unbiased.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch


def _per_rank_scale(xf: torch.Tensor, ranked: bool) -> torch.Tensor:
    """max(max |x|, 1e-12) / 127 over the whole tensor, or over each
    leading index when ``ranked`` (kept as [R, 1, …])."""
    a = xf.abs()
    if ranked:
        top = a.amax(dim=tuple(range(1, xf.ndim)), keepdim=True) if xf.ndim > 1 else a
    else:
        top = a.max()
    return torch.clamp(top, min=1e-12) / 127.0


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32 0-d)."""
    xf = x.float()
    scale = _per_rank_scale(xf, ranked=False)
    return _quantize(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(
    g: torch.Tensor, err: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale, new_err). new_err = (g+err) − deq(q)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_psum(
    g: torch.Tensor, err: torch.Tensor, axis_name: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed gradient all-reduce over the ranks of ``axis_name``:
    ``g`` and ``err`` are [R, …], rank r's gradient and residual at [r]
    (the reference's per-rank ``g`` and ``err`` inside ``shard_map``);
    ``axis_name`` names that dimension's mesh axis and selects nothing.

    Each rank compresses its corrected gradient with its own scale; the
    ranks agree on the largest scale (the reference's ``pmax``: a max over
    the rank dimension), requantize to it, and sum the int codes in int32
    (its ``psum``: a sum over that dimension). Returns (the f32 mean
    gradient, the same [R, …] for every rank; each rank's new residual)."""
    corrected = g.float() + err
    scale = _per_rank_scale(corrected, ranked=True)          # [R, 1, …]
    q = _quantize(corrected, scale)
    new_err = corrected - dequantize_int8(q, scale)
    smax = scale.max()
    q2 = torch.clamp(torch.round(dequantize_int8(q, scale) / smax), -127, 127).to(torch.int32)
    total = q2.sum(dim=0, dtype=torch.int32)
    mean = total.float() * smax / float(g.shape[0])
    return mean.expand_as(corrected), new_err


def init_error_state(grads) -> Any:
    """A zero f32 residual per gradient leaf, on its device."""
    if isinstance(grads, dict):
        return {k: init_error_state(v) for k, v in grads.items()}
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)
