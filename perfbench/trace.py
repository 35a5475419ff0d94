"""Spans around the calls into each layer, and the reading of a trace.

The program carries no spans of its own yet, so in a traced run the
benchmark wraps the entry of each layer it knows and times it on the
front end's clock (:func:`spans`; the profiler records ranges of the
calling thread only, and the layers run in the front end's threads),
and takes the wrappers out again when the window closes. An entry the
program no longer has is left out, and its span is absent. Each
batch's span comes from what the front end hands back with every
answer (``RequestResult.batch_id``, ``dispatch_s``, ``done_s``), not
from a wrapper. An untraced run runs the program untouched.

:func:`summarize` reads the profiler's raw events: the device's busy
time (the union of its operations' spans), the kernels launched, the
device time and launches inside each front-end batch, the device
operations that took the most time, and the device's idle gaps, each
put down to the innermost host span that covers it.
"""

from __future__ import annotations

import contextlib
import bisect
import functools
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
BATCH = "frontend.batch#"
HOST_OTHER = "frontend.between_batches"
SYNC = "perfbench.sync#"
SYNC_PROBES = 16
TOP = 10

# (module under repro_torch.serve, owner in it or None, attribute, span name)
LAYER_ENTRIES = (
    ("engine", "HarmonyServer", "search_batch", "engine.search_batch"),
    ("engine", None, "assign_queries", "engine.assign_queries"),
    ("executor", "SpmdExecutor", "search_batch", "executor.search_batch"),
    ("executor", "SpmdExecutor", "_gather_rows", "executor.gather_rows"),
    ("executor", None, "prewarm_tau", "executor.prewarm_tau"),
    ("executor", None, "gather_local_candidates", "executor.gather_candidates"),
    ("executor", None, "ring_chunk_search", "ring.ring_chunk_search"),
)


def _wrap(fn, name: str, sink: list, clock_ns: Callable[[], int]):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = clock_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append((t0, clock_ns(), name))
    return inner


@contextlib.contextmanager
def spans(sink: list, clock_ns: Callable[[], int]):
    """While the block runs, time each layer's entry point on the host
    clock ``clock_ns`` into ``sink`` as (start, end, name), in whichever
    thread it runs: engine → executor → ring. Yields the names of the
    entries the program lacks, whose spans are absent."""
    import importlib

    saved, absent = [], []
    for module, owner, attr, name in LAYER_ENTRIES:
        try:
            mod = importlib.import_module(f"repro_torch.serve.{module}")
        except ImportError:
            absent.append(name)
            continue
        target = mod if owner is None else getattr(mod, owner, None)
        orig = getattr(target, "__dict__", {}).get(attr)
        if not callable(orig):
            absent.append(name)
            continue
        saved.append((target, attr, orig))
        setattr(target, attr, _wrap(orig, name, sink, clock_ns))
    try:
        yield absent
    finally:
        for target, attr, orig in reversed(saved):
            setattr(target, attr, orig)


@contextlib.contextmanager
def window(clock_ns: Callable[[], int]):
    """A ``record_function`` range over the traced window, opened and shut
    in the calling thread, after ``SYNC_PROBES`` empty ranges that tie
    the host clock ``clock_ns`` to the profiler's: yields the list of
    each probe's host clock before and after it."""
    probes = []
    for i in range(SYNC_PROBES):
        a = clock_ns()
        with torch.profiler.record_function(f"{SYNC}{i}"):
            pass
        probes.append((a, clock_ns()))
    with torch.profiler.record_function(WINDOW):
        yield probes


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    shift_ns: Optional[int] = None
    batch_device_s: Dict[int, float] = field(default_factory=dict)
    batch_launches: Dict[int, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(merged: List[Tuple[int, int]], lo: int, hi: int) -> int:
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged)


_GENERIC = ("gpu_kernel_impl", "gpu_kernel_impl_nocast", "BinaryFunctor", "UnaryFunctor")
_FUNCTOR = re.compile(r"\w*(?:Functor|_impl|_kernel_cuda|_op)\w*")


def short_name(name: str) -> str:
    """A device operation's name without its signature: the function, and
    for ATen's generic kernels the functor that says what they compute
    (``elementwise_kernel.CompareEqFunctor``)."""
    if "<" not in name and "::" not in name:            # Memcpy HtoD (Pageable -> Device)
        return name[:96]
    n = name.replace("void ", "").replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    base = base.split("::")[-1] or base
    inner = n[len(n.split("<", 1)[0]):]
    found = [m for m in _FUNCTOR.findall(inner) if m not in _GENERIC]
    return (f"{base}.{found[0]}" if found else base)[:96]


def _kind(e) -> str:
    """What an event is, by its annotation flag and its name: a range of
    ``record_function``, a copy, a fill, or else a kernel."""
    if e.is_user_annotation():
        return "user_annotation"
    n = e.name()
    return "gpu_memcpy" if n.startswith("Memcpy") else "gpu_memset" if n.startswith(
        "Memset") else "kernel"


def _shift(host, probes) -> Optional[int]:
    """The profiler's clock less the host's, from the probe whose host
    readings lie closest together (a probe's range starts between them)."""
    starts = {n: a for a, _, n in host if n.startswith(SYNC)}
    best = None
    for i, (a, b) in enumerate(probes):
        if f"{SYNC}{i}" in starts and (best is None or b - a < best[0]):
            best = (b - a, starts[f"{SYNC}{i}"] - (a + b) // 2)
    return None if best is None else best[1]


def summarize(events, host_spans=(), probes=()) -> Optional[TraceSummary]:
    """Read raw profiler events (``prof.profiler.kineto_results.events()``
    or stand-ins with the same methods) and the host spans (those of
    :func:`spans`, and one ``BATCH<id>`` span a front-end batch), whose
    clock is moved onto the profiler's by the probes of :func:`window`.
    Returns None when the window's range is missing."""
    dev, host = [], []
    for e in events:
        kind = _kind(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if kind != "user_annotation":
                dev.append((e.start_ns(), e.end_ns(), e.name(), kind))
        elif kind == "user_annotation":
            host.append((e.start_ns(), e.end_ns(), e.name()))
    # a host range's mirror on the device timeline is no device operation
    names = {n for _, _, n in host}
    dev = [d for d in dev if d[2] not in names]
    win = [h for h in host if h[2] == WINDOW]
    shift = _shift(host, probes)
    if shift is not None:
        host += [(a + shift, b + shift, n) for a, b, n in host_spans]
    if not win:
        return None
    lo, hi = win[0][0], win[0][1]
    dev = [(max(a, lo), min(b, hi), n, t) for a, b, n, t in dev if b > lo and a < hi]
    merged = _union([(a, b) for a, b, _, _ in dev])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = {}
    for a, b, n, _ in dev:
        n = short_name(n)
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    s = TraceSummary(window_s=(hi - lo) / 1e9, shift_ns=shift,
                     busy_s=busy / 1e9,
                     launches=sum(1 for *_, t in dev if t == "kernel"))
    s.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    kernel_starts = sorted(a for a, _, _, t in dev if t == "kernel")
    for a, b, n in host:
        if n.startswith(BATCH) and lo <= a and b <= hi:
            bid = int(n[len(BATCH):])
            s.batch_device_s[bid] = _overlap(merged, a, b) / 1e9
            s.batch_launches[bid] = (bisect.bisect_right(kernel_starts, b)
                                     - bisect.bisect_left(kernel_starts, a))
    # sweep the window in time order over the host spans' edges and the
    # idle gaps' edges: each stretch of idle time goes to the latest-started
    # span open over it, so a gap across several host phases is shared out
    marks = []
    for i, (a, b, n) in enumerate(host):
        if n != WINDOW and not n.startswith(SYNC):
            marks += [(a, 1, i), (b, -1, i)]
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for ga, gb in zip(edges[0::2], edges[1::2]):
        if gb > ga:
            marks += [(ga, 2, 1), (gb, 2, -1)]
    marks.sort()
    open_: Dict[int, int] = {}
    idle, last = 0, lo
    gaps: Dict[str, float] = {}
    for t, kind, v in marks:
        if idle and t > last:
            span = max(open_, key=open_.get) if open_ else None
            name = host[span][2].split("#")[0] if span is not None else HOST_OTHER
            gaps[name] = gaps.get(name, 0.0) + (min(t, hi) - max(last, lo)) / 1e9
        last = max(last, t)
        if kind == 2:
            idle += v
        elif v is not None and kind == 1:
            open_[v] = t
        else:
            open_.pop(v, None)
    s.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return s
