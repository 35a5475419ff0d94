"""Wrapper of the CUDA partial-distance kernel (``csrc/partial_distance.cu``).

The port of the Pallas kernel ``repro/kernels/distance.py``. This wrapper
takes CUDA tensors only and launches the kernel or raises; the dispatch
by device lives in :mod:`repro_torch.kernels.ops`. The kernel is built
at the first call, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_SIG = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("partial_distance")
    fn = lib.partial_distance_update_f32
    if fn.argtypes is None:
        for f in (fn, lib.partial_distance_update_bf16):
            f.argtypes = _SIG
            f.restype = ctypes.c_int
        lib.partial_distance_error_string.argtypes = [ctypes.c_int]
        lib.partial_distance_error_string.restype = ctypes.c_char_p
        lib.partial_distance_ctas.argtypes = [ctypes.c_int] * 4
        lib.partial_distance_ctas.restype = ctypes.c_longlong
    return lib


def ctas(m: int, n: int, tile_m: int = 128, tile_n: int = 128) -> int:
    """The kernel's grid size (CTAs per launch) at [m, n] outputs."""
    return int(_lib().partial_distance_ctas(m, n, tile_m, tile_n))


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def partial_distance_update(
    x: torch.Tensor,       # [N, Db] f32 or bf16
    xn2: torch.Tensor,     # [N]
    q: torch.Tensor,       # [M, Db] f32
    qn2: torch.Tensor,     # [M]
    acc: torch.Tensor,     # [M, N] f32, +inf = pruned
    tau: torch.Tensor,     # [M]
    *,
    prune: bool = True,
    metric: str = "l2",
    tile_m: int = 128,
    tile_n: int = 128,
    tile_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acc' [M, N] f32, tile_skipped [m_tiles, n_tiles] int32).

    ``tile_m``/``tile_n`` set the skip map's granularity (each tile is
    covered by several CTAs); ``tile_k`` is the contraction chunk after
    which ``scale·dot`` is subtracted, as in the TPU kernel. Rows ``x``
    may be bf16 (the kernel's bf16 route widens them to f32 in registers);
    everything else is f32.
    """
    if metric not in ("l2", "ip"):
        raise ValueError(metric)
    if tile_m <= 0 or tile_n <= 0 or tile_k <= 0:
        raise ValueError((tile_m, tile_n, tile_k))
    n, d = x.shape
    m = q.shape[0]
    _check("x", x, (n, d), x.dtype if x.dtype == torch.bfloat16 else torch.float32)
    _check("xn2", xn2, (n,))
    _check("q", q, (m, d))
    _check("qn2", qn2, (m,))
    _check("acc", acc, (m, n))
    _check("tau", tau, (m,))
    devs = {t.device for t in (x, xn2, q, qn2, acc, tau)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    skip = torch.empty((-(-m // tile_m), -(-n // tile_n)), dtype=torch.int32,
                       device=x.device)
    if m == 0 or n == 0:
        return out, skip.fill_(1)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bf16 = x.dtype == torch.bfloat16
        fn = lib.partial_distance_update_bf16 if bf16 else lib.partial_distance_update_f32
        err = fn(
            x.data_ptr(), xn2.data_ptr(), q.data_ptr(), qn2.data_ptr(),
            acc.data_ptr(), tau.data_ptr(), out.data_ptr(), skip.data_ptr(),
            m, n, d, tile_m, tile_n, tile_k, int(metric == "l2"), int(bool(prune)),
            stream,
        )
    if err:
        raise RuntimeError("partial_distance_update launch failed: "
                           + lib.partial_distance_error_string(err).decode())
    partial_distance_update.launches += 1
    if bf16:
        partial_distance_update.bf16_launches += 1
    return out, skip


partial_distance_update.launches = 0          # every launch, both row types
partial_distance_update.bf16_launches = 0     # the launches on bf16 rows
