"""The τ prewarm's card route (``PrewarmSamples`` and
``kernels/csrc/tau_prewarm.cu``) on the CPU, through ``kernels.ops``'s plain
version.

τ0 of the card route equals the host route's bit for bit, for f32 and bf16
rows, 1, 2 and 4 dimension blocks, repeated and -1 probes, lists smaller
than the sample, fewer live samples than k (+inf) and tombstoned sample
rows; a device-tier executor answers alike on both routes, also for a
probe table wider than the kernel takes; the span's ``on_card`` counts
the queries the card route seeded; the wrapper refuses what the kernel
does not take; the host tier, the host engine and the int8 tier keep the
host route; the table is counted in the placement cost. The ``cuda`` case
holds the kernel against its plain version at a cell's shapes."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.config import HarmonyConfig
from repro_torch.core import Segment, assign_queries, build_ivf, segment_device_bytes
from repro_torch.core.index import prewarm_table_bytes
from repro_torch.core.pruning import PrewarmSamples, prewarm_tau
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tau_prewarm as kernel
from repro_torch.serve import ExecutorConfig, HarmonyServer
from repro_torch.serve.executor import SpmdExecutor

DIM, NLIST, NPROBE, K = 24, 48, 6, 5
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def data():
    """A corpus whose lists hold 0 to 9 rows (some fewer than the 4
    samples), its index, queries, their probe table and tombstones."""
    rng = np.random.default_rng(31)
    cent = rng.normal(size=(NLIST, DIM)).astype(np.float32) * 3
    x = np.repeat(cent, rng.integers(0, 10, size=NLIST), axis=0)
    x += 0.5 * rng.normal(size=x.shape).astype(np.float32)
    cfg = HarmonyConfig(dim=DIM, nlist=NLIST, nprobe=NPROBE, topk=K)
    index = build_ivf(x, cfg, centers=cent, device="cpu")
    q = (cent[rng.integers(0, NLIST, size=40)]
         + rng.normal(size=(40, DIM))).astype(np.float32)
    dead = rng.random(index.nb) < 0.4
    return index, q, assign_queries(index, q), dead


def odd_probes(probes):
    """The probe table with repeats (a filtered table's duplicate fill)
    and -1 columns."""
    p = probes.copy()
    p[::2, 1] = p[::2, 0]
    p[1::3, 3] = p[1::3, 2]
    p[::4, 4:] = -1
    return p


def executor(x_dtype="float32", d_blocks=1, **kw):
    index = data()[0]
    return SpmdExecutor(index, ExecutorConfig(d_blocks=d_blocks, x_dtype=x_dtype, chunk=64,
                                              qb_buckets=(64,), **kw), device="cpu")


@pytest.mark.parametrize("case", ["plain", "odd_probes", "tombstones", "odd_and_tombstones"])
@pytest.mark.parametrize("d_blocks", [1, 2, 4])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_card_route_equals_host_route(x_dtype, d_blocks, case):
    index, q, probes, dead = data()
    assert (index.sizes < 4).any() and (index.sizes == 0).any()
    samples = executor(x_dtype, d_blocks)._samples
    assert samples.table.dtype == (torch.bfloat16 if x_dtype == "bfloat16" else torch.float32)
    assert samples.table.shape == (np.minimum(index.sizes, 4).sum(), DIM) and samples.s == 4
    if "odd" in case:
        probes = odd_probes(probes)
    dead_rows = dead if "tombstones" in case else None
    rows_dtype = torch.bfloat16 if x_dtype == "bfloat16" else None
    short = 0
    for k in (1, K, 13, 24, 25):
        host = prewarm_tau(index, q, probes, k, 4, dead_rows=dead_rows, rows_dtype=rows_dtype)
        card = prewarm_tau(index, q, probes, k, 4, dead_rows=dead_rows, rows_dtype=rows_dtype,
                           samples=samples)
        assert card.dtype == np.float32 and card.shape == (len(q),)
        np.testing.assert_array_equal(card, host)
        short += int(np.isinf(card).sum())
    assert short > 0            # some queries have fewer than k live samples


@pytest.mark.parametrize("dead", [False, True], ids=["live", "tombstones"])
@pytest.mark.parametrize("d_blocks", [1, 4])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_executor_answers_equal_on_both_routes(x_dtype, d_blocks, dead):
    _, q, probes, dead_rows = data()
    dead_rows = dead_rows if dead else None
    ex = executor(x_dtype, d_blocks)
    kw = dict(k=K, probes=odd_probes(probes), dead_rows=dead_rows)
    card = ex.search_batch(q, **kw)
    ex._samples = None                   # the host route
    host = ex.search_batch(q, **kw)
    np.testing.assert_array_equal(card.ids, host.ids)
    np.testing.assert_array_equal(card.scores, host.scores)
    assert card.stats["tile_skipped"] == host.stats["tile_skipped"]


@pytest.mark.parametrize("tier", ["device", "host"])
def test_on_card_counts_the_queries_the_card_seeded(tier):
    index, q, _, _ = data()
    ex = SpmdExecutor(index, ExecutorConfig(chunk=64, qb_buckets=(64,)), tier=tier,
                      device="cpu")
    assert (ex._samples is not None) == (tier == "device")
    tracing.drain()
    tracing.enable()
    try:
        ops.reset_launch_counts()
        ex.search_batch(q)
        calls = ops.launch_counts()["tau_prewarm_ref"]
    finally:
        tracing.disable()
    spans = tracing.drain()
    (sp,) = [s for s in spans if s.name == "executor.prewarm_tau"]
    names = {s.name for s in spans}
    if tier == "device":
        assert sp.counts == {"on_card": len(q)} and calls == 1
        assert not names & {"tau.gather", "tau.upload"}
    else:
        assert sp.counts == {"on_card": 0} and calls == 0
        assert {"tau.gather", "tau.upload"} <= names


def _args(nq=3, p=4, s=4, d=8, nlist=5, table_dtype=torch.float32):
    return dict(table=torch.zeros((nlist * s, d), dtype=table_dtype),
                offs=torch.arange(0, nlist * s + 1, s, dtype=torch.int32),
                q=torch.zeros((nq, d)), probes=torch.zeros((nq, p), dtype=torch.int32),
                s=s, k=3, live=torch.ones((nlist * s,), dtype=torch.bool))


@pytest.mark.parametrize("bad,error,match", [
    (dict(table=torch.zeros((20, 8), dtype=torch.float64)), TypeError, "table"),
    (dict(table=torch.zeros((20, 8), dtype=torch.int8)), TypeError, "table"),
    (dict(offs=torch.arange(0, 21, 4, dtype=torch.int64)), TypeError, "offs"),
    (dict(q=torch.zeros((3, 8), dtype=torch.float64)), TypeError, "q"),
    (dict(probes=torch.zeros((3, 4), dtype=torch.int64)), TypeError, "probes"),
    (dict(live=torch.ones((20,), dtype=torch.uint8)), TypeError, "live"),
    (dict(offs=torch.zeros((6, 1), dtype=torch.int32)), ValueError, "offs"),
    (dict(offs=torch.zeros((0,), dtype=torch.int32)), ValueError, "offs"),
    (dict(q=torch.zeros((3, 9))), ValueError, "q"),
    (dict(q=torch.zeros((4, 8))), ValueError, "q"),
    (dict(live=torch.ones((19,), dtype=torch.bool)), ValueError, "live"),
    (dict(table=torch.zeros((5, 4, 8))), ValueError, "2-D"),
    (dict(q=torch.zeros((8, 3)).T), ValueError, "contiguous"),
    (dict(k=0), ValueError, "k=0"),
    (dict(s=-1), ValueError, "s=-1"),
    (dict(probes=torch.zeros((3, 1025), dtype=torch.int32)), ValueError, "4096"),
])
@pytest.mark.parametrize("entry", ["wrapper", "ops"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(entry, bad, error, match):
    fn = kernel.tau_prewarm if entry == "wrapper" else ops.tau_prewarm
    args = {**_args(), **bad}
    with pytest.raises(error, match=match):
        fn(**args)


def test_the_wrapper_launches_on_cuda_tensors_or_raises():
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.tau_prewarm(**_args())
    # the widest probe table the kernel takes, through the plain version:
    # list 0 probed 1,024 times is sampled once, its 4 rows at distance 0
    out = ops.tau_prewarm(**_args(p=1024, nlist=1))
    assert torch.equal(out, torch.zeros(3))
    assert ops.launch_counts()["tau_prewarm_ref"] == 1
    assert ops.launch_counts()["tau_prewarm"] == 0


def test_other_routes_keep_the_host_prewarm():
    """The int8 tier has no prewarm, a non-pruning executor none either,
    and the host engine (``backend="host"``) keeps ``prewarm_tau``'s host
    route."""
    index, q, _, _ = data()
    assert executor(precision="int8")._samples is None
    assert executor(prune=False)._samples is None
    srv = HarmonyServer(index, n_nodes=1, backend="host", device="cpu")
    ops.reset_launch_counts()
    srv.search_batch(q, K)
    assert ops.launch_counts()["tau_prewarm_ref"] == 0


def test_a_probe_table_wider_than_the_kernel_keeps_the_card_route():
    """Of a probe table wider than ``MAX_W // s`` columns the card route
    samples the first columns only: here one list, repeated, ahead of the
    real probes. τ0 is then no lower than the host route's over all of
    them, and +inf at k = K, since one list holds at most 4 samples; there
    the executor's answers are those of a search that does not prune. (A
    finite τ0 bounds the k-th distance in exact arithmetic, but the ring
    scores in the norm form and can put the k-th sample a few ulps above
    it: the unpruned search is the yardstick only where τ0 is +inf.)"""
    index, q, probes, dead = data()
    cut = kernel.MAX_W // 4
    wide = np.concatenate([np.repeat(probes[:, :1], cut, axis=1), probes[:, 1:]], axis=1)
    ex = executor()
    for k in (1, 3, K):
        card = prewarm_tau(index, q, wide, k, 4, samples=ex._samples, dead_rows=dead)
        host = prewarm_tau(index, q, wide, k, 4, dead_rows=dead)
        assert (card >= host).all() and (card > host).any()
    assert np.isinf(card).all()
    tracing.drain()
    tracing.enable()
    try:
        res = ex.search_batch(q, k=K, probes=wide, dead_rows=dead)
    finally:
        tracing.disable()
    (sp,) = [s for s in tracing.drain() if s.name == "executor.prewarm_tau"]
    assert sp.counts == {"on_card": len(q)}
    want = executor(prune=False).search_batch(q, k=K, probes=wide, dead_rows=dead)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.scores, want.scores)


def test_the_route_takes_only_the_tables_own_sample_and_type():
    index, q, probes, _ = data()
    samples = executor()._samples
    with pytest.raises(ValueError, match="4 rows a list"):
        prewarm_tau(index, q, probes, K, 3, samples=samples)
    with pytest.raises(ValueError, match="bfloat16"):
        prewarm_tau(index, q, probes, K, 4, rows_dtype=torch.bfloat16, samples=samples)
    with pytest.raises(ValueError, match="l2"):
        prewarm_tau(index, q, probes, K, 4, "ip", samples=samples)


def test_the_table_is_each_lists_first_rows():
    index, _, _, _ = data()
    smp = PrewarmSamples.build(index, 4, torch.float32, CPU)
    offs = smp.offs.numpy()
    np.testing.assert_array_equal(np.diff(offs), np.minimum(index.sizes, 4))
    assert offs[0] == 0 and offs[-1] == len(smp.table) == len(smp.rows) < index.nb
    for c in range(NLIST):
        lo, hi = index.cluster_rows(c)
        n = min(hi - lo, 4)
        assert torch.equal(smp.table[offs[c]:offs[c + 1]], index.x[lo:lo + n])
        np.testing.assert_array_equal(smp.rows[offs[c]:offs[c + 1]], np.arange(lo, lo + n))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_the_placement_cost_counts_the_resident_table(precision):
    """A device-tier executor's sample table, and nothing of it at int8,
    is what ``segment_device_bytes`` adds to the reference's currency."""
    index = data()[0]
    seg = Segment(seg_id=0, index=index)
    d = DIM if precision == "int8" else 4 * DIM
    rows_only = index.nb * (d + 4 + 8)
    smp = executor(precision=precision)._samples
    if precision == "int8":
        assert smp is None and segment_device_bytes(seg, precision) == rows_only
        return
    resident = smp.table.nbytes + smp.offs.nbytes
    assert resident == prewarm_table_bytes(index) > 0
    assert segment_device_bytes(seg, precision) == rows_only + resident
    off = dataclasses.replace(index, cfg=index.cfg.replace(enable_pruning=False))
    assert segment_device_bytes(Segment(seg_id=0, index=off), precision) == rows_only


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [128, 960])
def test_kernel_matches_plain_version_on_the_card(dim, x_dtype):
    """At a cell's shapes (8,000 queries, 16 probes with repeats and -1,
    4 samples of 1,024 lists, tombstones): one launch, τ0 within
    ``2 (D + 3) 2^-24 (‖q‖² + max ‖x‖²)`` of the plain version's on the
    card, and the same +inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(dim)
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    take = rng.integers(0, 5, size=1024)
    offs = torch.as_tensor(np.concatenate([[0], np.cumsum(take)]).astype(np.int32)).to(dev)
    t = int(take.sum())
    table = torch.as_tensor(rng.normal(size=(t, dim)).astype(np.float32)).to(dev, dtype)
    live = torch.as_tensor(rng.random(t) < 0.7).to(dev)
    q = torch.as_tensor(rng.normal(size=(8000, dim)).astype(np.float32)).to(dev)
    p = rng.integers(-1, 1024, size=(8000, 16)).astype(np.int32)
    p[::2, 1] = p[::2, 0]
    probes = torch.as_tensor(p).to(dev)
    ops.reset_launch_counts()
    got = ops.tau_prewarm(table, offs, q, probes, 4, 10, live).cpu().numpy()
    assert ops.launch_counts()["tau_prewarm"] == 1
    want = ref.tau_prewarm_ref(table, offs, q, probes, 4, 10, live).cpu().numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want)) and np.isfinite(want).any()
    xn2 = float((table.double() ** 2).sum(1).max())
    qn2 = (q.double() ** 2).sum(1).cpu().numpy()
    fin = np.isfinite(want)
    slack = 2 * (dim + 3) * 2.0 ** -24 * (qn2 + xn2)
    assert (np.abs(got - want.astype(np.float64))[fin] <= slack[fin]).all()
