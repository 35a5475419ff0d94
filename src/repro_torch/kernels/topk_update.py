"""Wrapper of the CUDA running-top-K kernel (``csrc/topk_update.cu``).

The port of the Pallas kernel ``repro/kernels/topk_update.py``. This
wrapper takes CUDA tensors only and launches the kernel or raises; the
dispatch by device lives in :mod:`repro_torch.kernels.ops`. The kernel is
built at the first call, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

WARP_MAX_K = 256     # route 1 (one warp a row, the list in registers) up to here
MAX_K = 12288        # route 2 (the list in shared memory: 16 K + 8 W bytes) up to here
MAX_INDEX = 2 ** 31 - 1  # K and C: the kernel indexes lists and columns as int
MAX_C = MAX_INDEX    # columns are read in windows
_SIG = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lib():
    lib = _build.load("topk_update")
    fn = lib.running_topk_update_f32
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
        lib.topk_update_error_string.argtypes = [ctypes.c_int]
        lib.topk_update_error_string.restype = ctypes.c_char_p
        lib.topk_update_max_k.argtypes = []
        lib.topk_update_max_k.restype = ctypes.c_int
        if lib.topk_update_max_k() != MAX_K:
            raise RuntimeError("csrc/topk_update.cu and topk_update.MAX_K disagree")
        lib.topk_update_route.argtypes = [ctypes.c_int]
        lib.topk_update_route.restype = ctypes.c_int
    return lib


def route(k: int) -> int:
    """The kernel route a list of ``k`` takes: 1 (one warp a row, K <= 256),
    2 (one CTA a row, the list in shared memory, K <= ``MAX_K``) or 3 (one
    CTA a row, the list in global memory)."""
    return 1 if k <= WARP_MAX_K else 2 if k <= MAX_K else 3


def check_limits(k: int, c: int) -> None:
    """Raise ``ValueError``, naming the limit, when the kernel cannot take
    a list of ``k`` or a chunk of ``c`` columns. Callers that choose K run
    it before any launch, on every device, so a K the card would refuse
    fails the same way on the CPU. Both are bounded only by the kernel's
    int index: route 3 keeps a list of any K in global memory."""
    if not 1 <= k <= MAX_INDEX:
        raise ValueError(f"k={k} outside 1..{MAX_INDEX}, the running top-K "
                         "kernel's int index")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"C={c} outside 1..{MAX_C}, the running top-K "
                         "kernel's limit")


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def running_topk_update(
    scores: torch.Tensor,      # [M, C] f32, +inf = invalid
    ids: torch.Tensor,         # [M, C] i32 (row stride C, or 0 = one row broadcast)
    run_s: torch.Tensor,       # [M, K] f32 ascending
    run_i: torch.Tensor,       # [M, K] i32
    *,
    k: int,
    tile_m: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a candidate chunk into the per-query running top-K.

    ``tile_m`` is accepted for signature parity; the kernel runs one CTA
    per query row (M CTAs): one warp for K <= 256, 256 threads up to
    ``MAX_K``, 1024 above, where an [M, K] scratch list is allocated here
    (:func:`route`). ``ids`` may be an expanded row (``id_c.expand(M, C)``).
    """
    m, c = scores.shape
    if k != run_s.shape[1]:
        raise ValueError(f"k={k} but the running list holds {run_s.shape[1]}")
    check_limits(k, c)
    _check("scores", scores, (m, c), torch.float32)
    _check("ids", ids, (m, c), torch.int32)
    _check("run_s", run_s, (m, k), torch.float32)
    _check("run_i", run_i, (m, k), torch.int32)
    for name, t in (("scores", scores), ("run_s", run_s), ("run_i", run_i)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ids.stride(1) != 1 or ids.stride(0) not in (0, c):
        raise ValueError(f"ids must have row stride {c} or 0 and unit column "
                         f"stride, got {ids.stride()}")
    devs = {t.device for t in (scores, ids, run_s, run_i)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    out_s = torch.empty((m, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=scores.device)
    if m == 0:
        return out_s, out_i
    lib = _lib()
    r = route(k)
    if lib.topk_update_route(k) != r:
        raise RuntimeError(f"csrc/topk_update.cu routes k={k} otherwise than route()")
    tmp_s = tmp_i = None
    if r == 3:
        tmp_s = torch.empty_like(out_s)
        tmp_i = torch.empty_like(out_i)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.running_topk_update_f32(
            scores.data_ptr(), ids.data_ptr(), ids.stride(0), run_s.data_ptr(),
            run_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            None if tmp_s is None else tmp_s.data_ptr(),
            None if tmp_i is None else tmp_i.data_ptr(), m, c, k, stream,
        )
    if err:
        raise RuntimeError("running_topk_update launch failed: "
                           + lib.topk_update_error_string(err).decode())
    running_topk_update.launches += 1
    if r == 2:
        running_topk_update.large_k_launches += 1
    elif r == 3:
        running_topk_update.huge_k_launches += 1
    return out_s, out_i


running_topk_update.launches = 0          # every launch, all routes
running_topk_update.large_k_launches = 0  # the launches of route 2
running_topk_update.huge_k_launches = 0   # the launches of route 3
