"""Shared model building blocks: norms, RoPE (incl. M-RoPE), GQA attention
(causal / bidirectional / sliding-window / softcap, prefill + decode),
SwiGLU/GeLU FFN, init helpers.

The port of ``repro.models.common``: the same functions over nested dicts
of tensors, in the same arithmetic. Compute dtype = ``cfg.dtype`` (bf16 by
default); norms, RoPE angles, attention logits and the softmax in f32,
the attention weights cast to the values' dtype before the second
product. Initializers draw from an explicit ``torch.Generator`` on the
device the tensors are made on (the reference's ``jax.random`` streams
cannot be reproduced; tests carry the reference's weights across).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class ShapeOnly:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, where no
    generator can live: the init helpers make their tensors there (shapes
    and dtypes, no storage) and draw nothing."""

    device = torch.device("meta")


def _trunc_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """f32 standard normal truncated to [−2, 2] on ``gen``'s device (on
    ``meta``, the tensor undrawn)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.device.type == "meta":
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, dtype=torch.bfloat16):
    """Truncated normal on [−2, 2] in f32 scaled by 1/√fan_in, cast to
    ``dtype``; made on ``gen``'s device."""
    return (_trunc_normal(gen, shape) * _f32_rsqrt(shape[in_axis])).to(dtype)


def _f32_rsqrt(n: int) -> float:
    """1 / √n as the reference computes it: the root, then the quotient,
    each rounded to f32 (a Python float, so no tensor is made on a device)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16):
    return _trunc_normal(gen, shape).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd] rotated by ang [..., S, half] (f32)."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; pos broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [half]
    return _rotate(x, pos.float()[..., None] * freqs)


def apply_mrope(
    x: torch.Tensor, pos3: torch.Tensor, theta: float, sections: Sequence[int] = (16, 24, 24)
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the half-dim frequency bands are split into
    (temporal, height, width) sections, each rotated by its own position.

    x [B, S, H, hd]; pos3 [3, B, S]. For text tokens pos3[i] are all equal,
    which reduces exactly to standard RoPE.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [half]
    sec = torch.cat([torch.full((n,), i, device=x.device) for i, n in enumerate(sections)])
    pos_per_freq = torch.movedim(pos3[sec], 0, -1)            # [B, S, half]
    return _rotate(x, pos_per_freq.float() * freqs)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, (d, H * hd), 0, dt),
        "wk": dense_init(gen, (d, KV * hd), 0, dt),
        "wv": dense_init(gen, (d, KV * hd), 0, dt),
        "wo": dense_init(gen, (H * hd, d), 0, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=gen.device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dt, device=gen.device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dt, device=gen.device)
    return p


def _qkv(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(B, S, H, hd),
        k.reshape(B, S, KV, hd),
        v.reshape(B, S, KV, hd),
    )


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _attend_dense(q, k, v, mask, softcap: float) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,H,hd] (KV repeated to H outside), mask
    [B?,Sq,Sk] bool (True = attend). f32 logits and softmax; a row with
    nothing to attend gets uniform weights (−1e30, not −inf)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = _softcap(logits * _f32_rsqrt(q.shape[-1]), softcap)
    logits = logits.masked_fill(~mask[:, None, :, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _rope_qk(cfg: ModelConfig, q, k, pos):
    """RoPE / M-RoPE on q and k; returns (q, k, the [B, S] position row)."""
    if cfg.rope_style == "mrope":
        return (apply_mrope(q, pos, cfg.rope_theta), apply_mrope(k, pos, cfg.rope_theta),
                pos[0])
    if cfg.rope_style == "rope":
        return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), pos
    return q, k, (pos if pos.dim() == 2 else pos[0])


def attention(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,                     # [B, S, D]
    pos: torch.Tensor,                   # [B, S] or [3, B, S] for mrope
    *,
    causal: bool = True,
    sliding_window: int = 0,
    q_chunk: int = 1024,
    unroll_chunks: bool = False,
    kv_range_chunking: bool = False,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill) over q chunks of
    ``q_chunk`` rows. (The reference pads q to a multiple of ``q_chunk``
    and drops the padded rows; a row's output does not depend on the rows
    beside it, so the port's last chunk is just shorter.)

    ``kv_range_chunking`` applies where the reference applies it, on the
    ``unroll_chunks`` branch only: each q chunk then reads the KV positions
    it can attend — ``[0, chunk_end)``, from ``chunk_start − window + 1``
    for a causal sliding window — instead of masking the full sequence.
    Token order must be the natural arange.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, cfg, x)
    q, k, pos_row = _rope_qk(cfg, q, k, pos)
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)

    def chunk_out(qc, qpos, kc, vc, kposc):
        # qc [B, C, H, hd]; kc/vc [B, L, H, hd]
        m = torch.ones((B, qc.shape[1], kc.shape[1]), dtype=torch.bool, device=x.device)
        if causal:
            m &= qpos[:, :, None] >= kposc[:, None, :]
        if sliding_window and sliding_window > 0:
            m &= qpos[:, :, None] - kposc[:, None, :] < sliding_window
        return _attend_dense(qc, kc, vc, m, cfg.attn_logit_softcap)

    outs = []
    for start in range(0, S, q_chunk):
        end = min(S, start + q_chunk)
        kv = slice(None)
        if unroll_chunks and kv_range_chunking and S > q_chunk:
            lo = 0
            if causal and sliding_window and sliding_window > 0:
                lo = max(0, start - sliding_window + 1)
            kv = slice(lo, end)
        outs.append(chunk_out(q[:, start:end], pos_row[:, start:end], k[:, kv], v[:, kv],
                              pos_row[:, kv]))
    out = torch.cat(outs, dim=1)

    return out.reshape(B, S, H * hd) @ p["wo"]


def _write_slot(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """cache[b, slot[b]] = new[b] for every row b, in place. The reference's
    one-hot blend ``cache·(1−oh) + oh·new`` gives these values on a finite
    cache."""
    cache[torch.arange(cache.shape[0], device=cache.device), slot.long()] = new


def attention_decode(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,                     # [B, 1, D]
    pos: torch.Tensor,                   # [B] current position (or [3,B])
    k_cache: torch.Tensor,               # [B, Smax, KV, hd]
    v_cache: torch.Tensor,
    *,
    sliding_window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache. Returns (out [B,1,D], k', v').

    The new key and value are written into ``k_cache``/``v_cache`` in place
    at each row's position, and the same tensors are returned as k', v';
    the query attends over the whole ``Smax`` with the mask ``idx ≤ pos``
    (and the window, if any).
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Smax = k_cache.shape[1]
    q, k, v = _qkv(p, cfg, x)                                # [B,1,·,hd]
    if cfg.rope_style == "mrope":
        pos3 = pos if pos.dim() == 2 else pos[None].expand(3, B)
        q, k, pos_row = _rope_qk(cfg, q, k, pos3[:, :, None])
        pos_row = pos_row[:, 0]
    else:
        q, k, _ = _rope_qk(cfg, q, k, pos[:, None])
        pos_row = pos

    _write_slot(k_cache, pos_row, k[:, 0])
    _write_slot(v_cache, pos_row, v[:, 0])

    kk = _repeat_kv(k_cache, H // KV)
    vv = _repeat_kv(v_cache, H // KV)
    idx = torch.arange(Smax, device=x.device)[None, :]       # [1, Smax]
    m = idx <= pos_row[:, None]
    if sliding_window and sliding_window > 0:
        m &= pos_row[:, None] - idx < sliding_window
    out = _attend_dense(q, kk, vv, m[:, None, :], cfg.attn_logit_softcap)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(cfg: ModelConfig, gen: torch.Generator, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    if cfg.mlp == "swiglu":
        return {
            "w1": dense_init(gen, (d, f), 0, dt),     # gate
            "w3": dense_init(gen, (d, f), 0, dt),     # up
            "w2": dense_init(gen, (f, d), 0, dt),     # down
        }
    return {
        "w1": dense_init(gen, (d, f), 0, dt),
        "w2": dense_init(gen, (f, d), 0, dt),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · logistic(x), the logistic as XLA expands it,
    1 / (1 + exp(−x)), each step rounded to x's dtype (bit for bit in bf16)."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op for op in x's dtype, its
    constants rounded to that dtype (bit for bit in bf16)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


def ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return (_silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    return _gelu_tanh(x @ p["w1"]) @ p["w2"]
