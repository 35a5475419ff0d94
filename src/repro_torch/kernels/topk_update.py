"""Wrapper of the CUDA running-top-K kernel (``csrc/topk_update.cu``).

The port of the Pallas kernel ``repro/kernels/topk_update.py``. This
wrapper takes CUDA tensors only and launches the kernel or raises; the
dispatch by device lives in :mod:`repro_torch.kernels.ops`. The kernel is
built at the first call, never at import. :func:`plan` says, without the
card, how a call is launched (``chip_smoke.py`` holds it equal to the
source's ``topk_update_plan``); the launch itself does not consult it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build

WARP_MAX_K = 64      # route 1 (one warp a row, the list in registers) up to here
MAX_K = 12288        # route 2 (the list in shared memory: 16 K + 16 W bytes) up to here
MAX_INDEX = 2 ** 31 - 1  # K and C: the kernel indexes lists and columns as int
MAX_C = MAX_INDEX    # columns are read in windows
# the geometry of routes 2 and 3, for plan() (the constants of csrc/topk_update.cu)
ROUTE2_THREADS, ROUTE2_MAX_WINDOW, ROUTE2_SMEM = 256, 2048, 16 * MAX_K + 16 * 1024
TILE, MAX_TILE, ROUTE3_CTAS = 256, 4096, 132
FUSE_C, ROUTE3_WINDOW, ROUTE3_CHUNK = 2048, 8192, 1 << 18
_SIG = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
        + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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
        for k in (1, WARP_MAX_K, WARP_MAX_K + 1, MAX_K, MAX_K + 1, MAX_INDEX):
            if lib.topk_update_route(k) != route(k):
                raise RuntimeError(f"csrc/topk_update.cu routes k={k} otherwise than route()")
        lib.topk_update_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.topk_update_scratch_bytes.restype = ctypes.c_longlong
        lib.topk_update_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.topk_update_plan.restype = None
    return lib


def route(k: int) -> int:
    """The kernel route a list of ``k`` takes: 1 (one warp a row, the list
    in registers, K <= ``WARP_MAX_K``), 2 (one CTA a row, the list in shared
    memory, K <= ``MAX_K``) or 3 (many CTAs a row, the list in global
    memory)."""
    return 1 if k <= WARP_MAX_K else 2 if k <= MAX_K else 3


def _pow2_window(c: int, lo: int, hi: int) -> int:
    w = lo
    while w < c and w < hi:
        w *= 2
    return w


@dataclass(frozen=True)
class Plan:
    """How one call at (M, C, K) is launched."""

    route: int
    ctas: int             # CTAs of the launch that writes the output
    window: int           # columns whose survivors are compacted together
    launches: int         # kernel launches of the call
    smem_bytes: int       # the largest dynamic shared memory of a launch
    scratch_bytes: int    # device scratch the wrapper allocates


def route3_tile(m: int, k: int) -> int:
    """Route 3's output positions a CTA: the least power-of-two multiple of
    ``TILE`` (up to ``MAX_TILE``) that keeps a launch within
    ``ROUTE3_CTAS`` CTAs, one wave of the card's 132 SMs."""
    t = TILE
    while t < MAX_TILE and m * -(-k // t) > ROUTE3_CTAS:
        t *= 2
    return t


def plan(m: int, c: int, k: int) -> Plan:
    """The launch plan of a call at (M = ``m``, C = ``c``, K = ``k``): route
    1 is M one-warp CTAs; route 2 M CTAs of 256 threads over windows of
    256..2048 columns, as wide as C and the shared memory allow; route 3
    cuts each row's K output positions into tiles of :func:`route3_tile`
    (one CTA each), and above ``FUSE_C`` columns first compacts windows of
    ``ROUTE3_WINDOW`` into sorted runs and merges them pairwise in a
    scratch, per chunk of ``ROUTE3_CHUNK`` columns."""
    r = route(k)
    if r == 1:
        return Plan(1, m, 256, 1, 0, 0)
    if r == 2:
        w = _pow2_window(c, ROUTE2_THREADS, ROUTE2_MAX_WINDOW)
        while w > ROUTE2_THREADS and 16 * k + 16 * w > ROUTE2_SMEM:
            w //= 2
        return Plan(2, m, w, 1, 16 * k + 16 * w, 0)
    tile = route3_tile(m, k)
    ctas = m * -(-k // tile)
    if c <= FUSE_C:
        w = _pow2_window(c, 256, FUSE_C)
        return Plan(3, ctas, w, 1, 16 * w + 8 * (c + tile), 0)
    chunk = min(c, ROUTE3_CHUNK)
    nwin_ld = -(-chunk // ROUTE3_WINDOW)
    launches = 0
    for base in range(0, c, chunk):
        nwin = -(-min(chunk, c - base) // ROUTE3_WINDOW)
        launches += 2 + (nwin - 1).bit_length()
    scratch = 2 * m * nwin_ld * ROUTE3_WINDOW * 8 + 2 * m * nwin_ld * 4
    if c > ROUTE3_CHUNK:
        scratch += 8 * m * k
    return Plan(3, ctas, ROUTE3_WINDOW, launches, 16 * ROUTE3_WINDOW, scratch)


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

    ``tile_m`` is accepted for signature parity; the kernel's geometry is
    :func:`plan`'s: one warp a row for K <= ``WARP_MAX_K``, a CTA of 256
    threads a row up to ``MAX_K``, a CTA per :func:`route3_tile` output
    positions above (:func:`route`), where any scratch is allocated here.
    ``ids`` may be an expanded row (``id_c.expand(M, C)``).
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
    nbytes = lib.topk_update_scratch_bytes(m, c, k) if r == 3 else 0
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=scores.device)
               if nbytes else None)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.running_topk_update_f32(
            scores.data_ptr(), ids.data_ptr(), ids.stride(0), run_s.data_ptr(),
            run_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nbytes, m, c, k, stream,
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


def launched_plan(m: int, c: int, k: int) -> Plan:
    """The plan the source launches a call at (M, C, K) with (its
    ``topk_update_plan``; builds the kernel, so card only)."""
    out = (ctypes.c_longlong * 6)()
    _lib().topk_update_plan(m, c, k, out)
    return Plan(*(int(v) for v in out))
