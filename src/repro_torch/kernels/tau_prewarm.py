"""Wrapper of the CUDA τ-prewarm kernel (``csrc/tau_prewarm.cu``).

Replaces no TPU kernel (the JAX package's prewarm is plain numpy): it
scores each query's sample rows of its probed lists out of a resident
table and keeps the k-th smallest, one launch a batch. This wrapper takes
CUDA tensors only and launches the kernel or raises; the dispatch by
device lives in :mod:`repro_torch.kernels.ops`. :func:`check` holds the
arguments to what the kernel takes on every device, so both routes refuse
the same calls. The kernel is built at the first call, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_W = 4096         # probes · samples a query: the score slots a CTA sorts
_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("tau_prewarm")
    fn = lib.tau_prewarm_f32
    if fn.argtypes is None:
        for f in (fn, lib.tau_prewarm_bf16):
            f.argtypes = _SIG
            f.restype = ctypes.c_int
        lib.tau_prewarm_error_string.argtypes = [ctypes.c_int]
        lib.tau_prewarm_error_string.restype = ctypes.c_char_p
        lib.tau_prewarm_max_w.argtypes = []
        lib.tau_prewarm_max_w.restype = ctypes.c_int
        if lib.tau_prewarm_max_w() != MAX_W:
            raise RuntimeError("csrc/tau_prewarm.cu and tau_prewarm.MAX_W disagree")
    return lib


def _expect(name: str, t: torch.Tensor, shape, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(table: torch.Tensor, offs: torch.Tensor, q: torch.Tensor,
          probes: torch.Tensor, s: int, k: int,
          live: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel does not take: a table [T, D] of f32 or
    bf16 rows, offs [nlist + 1] int32, queries [NQ, D] f32, probes [NQ, P]
    int32, live [T] bool, s >= 0, k >= 1, and P · s <= ``MAX_W``. That the
    offsets rise from 0 to T, at most s apart, is the caller's to keep."""
    if table.dim() != 2 or q.dim() != 2 or probes.dim() != 2:
        raise ValueError(f"table, q and probes must be 2-D, got "
                         f"{tuple(table.shape)}, {tuple(q.shape)}, {tuple(probes.shape)}")
    t, d = table.shape
    nq, p = probes.shape
    _expect("table", table, (t, d), (torch.float32, torch.bfloat16))
    if offs.dim() != 1 or offs.shape[0] < 1:
        raise ValueError(f"offs has shape {tuple(offs.shape)}, expected [nlist + 1]")
    _expect("offs", offs, (offs.shape[0],), (torch.int32,))
    _expect("q", q, (nq, d), (torch.float32,))
    _expect("probes", probes, (nq, p), (torch.int32,))
    if live is not None:
        _expect("live", live, (t,), (torch.bool,))
    if s < 0:
        raise ValueError(f"s={s}: a list's sample rows, s >= 0")
    if k < 1:
        raise ValueError(f"k={k}: the prewarm keeps the k-th smallest, k >= 1")
    if p * s > MAX_W:
        raise ValueError(f"{p} probes x {s} samples = {p * s} score slots a query, "
                         f"over the kernel's {MAX_W}")
    devs = {x.device for x in (table, offs, q, probes) + ((live,) if live is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def tau_prewarm(
    table: torch.Tensor,     # [T, D] f32 or bf16: each list's first rows, packed
    offs: torch.Tensor,      # [nlist + 1] int32: list c is table[offs[c]:offs[c + 1]]
    q: torch.Tensor,         # [NQ, D] f32
    probes: torch.Tensor,    # [NQ, P] int32; < 0 skipped, a repeat taken once
    s: int,                  # the most rows a list has in the table
    k: int,
    live: Optional[torch.Tensor] = None,   # [T] bool; None: all live
) -> torch.Tensor:
    """τ0 [NQ] f32: each query's k-th smallest Σ(x − q)² over the live sample
    rows of its distinct probed lists, +inf where fewer than k were scored."""
    check(table, offs, q, probes, s, k, live)
    for name, t in (("table", table), ("q", q)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    d = table.shape[1]
    nlist = offs.shape[0] - 1
    nq, p = probes.shape
    tau = torch.empty((nq,), dtype=torch.float32, device=q.device)
    if nq == 0:
        return tau
    if p * s == 0:
        return tau.fill_(float("inf"))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        bf16 = table.dtype == torch.bfloat16
        fn = lib.tau_prewarm_bf16 if bf16 else lib.tau_prewarm_f32
        err = fn(table.data_ptr(), offs.data_ptr(),
                 live.data_ptr() if live is not None else None,
                 q.data_ptr(), probes.data_ptr(), tau.data_ptr(),
                 nq, nlist, s, d, p, int(k), stream)
    if err:
        raise RuntimeError("tau_prewarm launch failed: "
                           + lib.tau_prewarm_error_string(err).decode())
    tau_prewarm.launches += 1
    return tau


tau_prewarm.launches = 0      # every launch, both row types
