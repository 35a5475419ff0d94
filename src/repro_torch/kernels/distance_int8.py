"""Wrapper of the CUDA int8 partial-distance kernel
(``csrc/partial_distance_int8.cu``).

The port of the Pallas kernel ``repro/kernels/distance_int8.py``. This
wrapper takes CUDA tensors only and launches the kernel or raises; the
dispatch by device lives in :mod:`repro_torch.kernels.ops`. The kernel is
built at the first call, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance import _check

MAX_TILE_K = 1024     # keeps each chunk's int32 dot below 2^24: exact in f32
_SIG = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("partial_distance_int8")
    fn = lib.int8_partial_distance_update
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
        lib.partial_distance_int8_error_string.argtypes = [ctypes.c_int]
        lib.partial_distance_int8_error_string.restype = ctypes.c_char_p
        lib.int8_partial_distance_ctas.argtypes = [ctypes.c_int] * 4
        lib.int8_partial_distance_ctas.restype = ctypes.c_longlong
    return lib


def ctas(m: int, n: int, tile_m: int = 128, tile_n: int = 128) -> int:
    """The kernel's grid size (CTAs per launch) at [m, n] outputs."""
    return int(_lib().int8_partial_distance_ctas(m, n, tile_m, tile_n))


def int8_partial_distance_update(
    x: torch.Tensor,       # [N, Db] int8 codes
    xn2: torch.Tensor,     # [N] f32, s²·Σcode²
    q: torch.Tensor,       # [M, Db] int8 codes
    qn2: torch.Tensor,     # [M] f32, s²·Σcode²
    scale2: torch.Tensor,  # [] or [1] f32, shared s² of this block
    acc: torch.Tensor,     # [M, N] f32, +inf = pruned
    tau: torch.Tensor,     # [M]
    *,
    prune: bool = True,
    tile_m: int = 128,
    tile_n: int = 128,
    tile_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acc' [M, N] f32, tile_skipped [m_tiles, n_tiles] int32).

    ``tile_m``/``tile_n`` set the skip map's granularity (each tile is
    covered by several CTAs); ``tile_k`` is the contraction chunk after
    which the int32 dot is folded into the f32 value, as in the TPU
    kernel.
    """
    if tile_m <= 0 or tile_n <= 0:
        raise ValueError((tile_m, tile_n))
    if not 0 < tile_k <= MAX_TILE_K:
        raise ValueError(f"tile_k={tile_k} outside 1..{MAX_TILE_K}")
    n, d = x.shape
    m = q.shape[0]
    _check("x", x, (n, d), torch.int8)
    _check("xn2", xn2, (n,))
    _check("q", q, (m, d), torch.int8)
    _check("qn2", qn2, (m,))
    _check("scale2", scale2, tuple(scale2.shape))
    if scale2.numel() != 1:
        raise ValueError(f"scale2 must hold one value, got {tuple(scale2.shape)}")
    _check("acc", acc, (m, n))
    _check("tau", tau, (m,))
    devs = {t.device for t in (x, xn2, q, qn2, scale2, acc, tau)}
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
        err = lib.int8_partial_distance_update(
            x.data_ptr(), xn2.data_ptr(), q.data_ptr(), qn2.data_ptr(),
            scale2.data_ptr(), acc.data_ptr(), tau.data_ptr(), out.data_ptr(),
            skip.data_ptr(), m, n, d, tile_m, tile_n, tile_k, int(bool(prune)),
            stream,
        )
    if err:
        raise RuntimeError("int8_partial_distance_update launch failed: "
                           + lib.partial_distance_int8_error_string(err).decode())
    int8_partial_distance_update.launches += 1
    return out, skip


int8_partial_distance_update.launches = 0
