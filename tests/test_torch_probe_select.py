"""Probe selection with the port's own kernels
(``core.search.kernel_assign_queries``, ``SpmdExecutor.select_probes``)
and the engine's choice of route: on the ops' CPU path the table agrees
with ``assign_queries`` row by row up to f32 rounding (the allowance of
``perfbench/references/ivf_flat.py``), at widths 16, 128 and 960 and on
each top-K route; ``probes_on_card`` picks the card exactly for a CUDA
device, no filter and ``nprobe <= nlist``; a CPU engine and a filtered
batch keep numpy; on the card route the hotness, the probe window and the
executor get one table; the ``engine.assign_queries`` span counts
``on_card``. The ``cuda`` case runs the route at the cells' shapes."""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.config import HarmonyConfig
from repro_torch.core import TagIn, build_ivf
from repro_torch.core.index import assign_queries
from repro_torch.core.search import kernel_assign_queries
from repro_torch.kernels import ops, topk_update
from repro_torch.serve import ExecutorConfig, HarmonyServer, SpmdExecutor
from repro_torch.serve import engine as t_engine

NLIST = 128
U32 = 2.0 ** -24


def mixture(rng, n, centres, spread=0.25):
    comp = rng.integers(0, len(centres), n)
    noise = rng.standard_normal((n, centres.shape[1])) / np.sqrt(centres.shape[1])
    return (centres[comp] + spread * noise).astype(np.float32)


def centroids_and_queries(dim, nq, seed, nlist=NLIST):
    """Unit centres, centroids and queries drawn around them, and one
    centroid repeated, so one pair of columns ties exactly."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((nlist // 4, dim))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    cent = mixture(rng, nlist, centres)
    cent[1] = cent[0]
    return cent, mixture(rng, nq, centres)


def within_rounding(got, want, cent, q, nprobe):
    """Row by row: where ``got`` differs from ``want``, both choices at
    that rank lie within f32 rounding of the true (float64) distance of
    that rank: ``2 (D + 3) 2^-24 (|q|^2 + max |c|^2)`` for each of the two
    f32 computations."""
    c64, q64 = cent.astype(np.float64), q.astype(np.float64)
    d = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ c64.T + (c64 * c64).sum(1)[None, :]
    srt = np.sort(d, axis=1)[:, :nprobe]
    slack = 2.0 * 2.0 * (q.shape[1] + 3) * U32 * ((q64 * q64).sum(1) + (c64 * c64).sum(1).max())
    assert got.shape == want.shape == (q.shape[0], nprobe) and got.dtype == np.int32
    for row in range(q.shape[0]):
        assert len(set(got[row].tolist())) == nprobe, row
    diff = got != want
    for row, j in zip(*np.nonzero(diff)):
        for table in (got, want):
            assert abs(d[row, table[row, j]] - srt[row, j]) <= slack[row], (row, j)


@pytest.mark.parametrize("nprobe", [3, 16, 100, NLIST])
@pytest.mark.parametrize("dim", [16, 128, 960])
def test_kernel_route_agrees_with_assign_queries(dim, nprobe):
    cent, q = centroids_and_queries(dim, 192, seed=dim + nprobe)
    cfg = HarmonyConfig(dim=dim, nlist=NLIST, nprobe=nprobe, topk=5)
    index = build_ivf(cent, cfg, centers=cent, device="cpu")
    ct = torch.as_tensor(cent)
    ops.reset_launch_counts()
    got = kernel_assign_queries(ct, (ct * ct).sum(1), torch.as_tensor(q), nprobe)
    # one distance call and one top-K call over all the columns; K > 64 is
    # the kernel's route 2 on the card
    counts = ops.launch_counts()
    assert counts["partial_distance_update_ref"] == counts["running_topk_ref"] == 1
    assert topk_update.route(nprobe) == (1 if nprobe <= 64 else 2)
    within_rounding(got.numpy(), assign_queries(index, q, nprobe), cent, q, nprobe)


@pytest.mark.parametrize("device,filtered,nprobe,want", [
    ("cuda", False, 16, True),
    ("cuda", False, 1024, True),
    ("cpu", False, 16, False),
    ("cuda", True, 16, False),
    ("cuda", False, 1025, False),
    ("cuda", False, 0, False),
])
def test_probes_on_card_predicate(device, filtered, nprobe, want):
    """Each case flips one input of the first: the device, the filter,
    ``nprobe`` above ``nlist`` (1,024) or below 1."""
    assert t_engine.probes_on_card(torch.device(device), filtered, nprobe, 1024) is want


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    cfg = HarmonyConfig(dim=16, nlist=12, nprobe=3, topk=5, kmeans_iters=2)
    meta = {"tag": np.arange(len(x)) % 2}
    return x, build_ivf(x, cfg, meta=meta, device="cpu")


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def server(index):
    return HarmonyServer(index, n_nodes=1, backend="spmd", device="cpu",
                         executor_cfg=ExecutorConfig(chunk=64, qb_buckets=(32,)))


def spy(monkeypatch, srv):
    """Record the probe table that reaches the hotness, the probe window,
    each executor and each route."""
    seen = {"note": [], "exec": [], "numpy": 0, "card": 0}
    note = srv.data.note_probes

    def note_probes(seg_id, probes):
        seen["note"].append(probes)
        note(seg_id, probes)

    def search_batch(ex, *a, probes=None, **kw):
        seen["exec"].append(probes)
        return orig_search(ex, *a, probes=probes, **kw)

    def numpy_route(*a, **kw):
        seen["numpy"] += 1
        return orig_assign(*a, **kw)

    def card_route(ex, *a, **kw):
        seen["card"] += 1
        return orig_select(ex, *a, **kw)

    orig_search, orig_select = SpmdExecutor.search_batch, SpmdExecutor.select_probes
    orig_assign = t_engine.assign_queries
    monkeypatch.setattr(srv.data, "note_probes", note_probes)
    monkeypatch.setattr(SpmdExecutor, "search_batch", search_batch)
    monkeypatch.setattr(SpmdExecutor, "select_probes", card_route)
    monkeypatch.setattr(t_engine, "assign_queries", numpy_route)
    return seen


def assign_span():
    (sp,) = [s for s in tracing.drain() if s.name == "engine.assign_queries"]
    return sp


@pytest.mark.parametrize("filtered", [False, True])
def test_cpu_engine_keeps_numpy(monkeypatch, plane, filtered):
    x, index = plane
    srv = server(index)
    seen = spy(monkeypatch, srv)
    flt = TagIn("tag", (0,)) if filtered else None
    tracing.enable()
    srv.search_batch(x[:20], flt=flt)
    assert seen["card"] == 0 and seen["numpy"] == (0 if filtered else 1)
    assert assign_span().counts == {"on_card": 0}


def test_card_route_hands_one_table_to_every_consumer(monkeypatch, plane):
    """The card route forced on the CPU (its ops take their plain path):
    the hotness, the probe window and the executor each get the table
    ``select_probes`` made, and the answers are the numpy route's."""
    x, index = plane
    q = x[:20] + 0.01
    want = server(index).search_batch(q)
    srv = server(index)
    seen = spy(monkeypatch, srv)
    monkeypatch.setattr(t_engine, "probes_on_card", lambda *a: True)
    tracing.enable()
    res = srv.search_batch(q)
    assert seen["card"] == 1 and seen["numpy"] == 0
    (note,), (given,) = seen["note"], seen["exec"]
    assert note is given and srv._recent_probes[-1] is given
    assert given.dtype == np.int32 and given.shape == (20, index.cfg.nprobe)
    np.testing.assert_array_equal(given, assign_queries(index, q))
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.scores, want.scores)
    assert assign_span().counts == {"on_card": 20}


@pytest.mark.cuda
@pytest.mark.parametrize("nprobe", [16, 100])
@pytest.mark.parametrize("dim", [128, 960])
def test_select_probes_on_the_card(dim, nprobe):
    """At a cell's shapes (8,000 queries, 1,024 centroids; 16 probes, and
    100 for the top-K kernel's route 2): two kernel launches, no
    plain-version call, the table within rounding of numpy's, and nothing
    but the centroids left on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cent, q = centroids_and_queries(dim, 8000, seed=dim + nprobe, nlist=1024)
    cfg = HarmonyConfig(dim=dim, nlist=1024, nprobe=nprobe, topk=10)
    index = build_ivf(cent, cfg, centers=cent, device="cuda")
    ex = SpmdExecutor(index, ExecutorConfig(chunk=256, qb_buckets=(8,)), device="cuda")
    ex.select_probes(q[:8])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    got = ex.select_probes(q)
    counts = ops.launch_counts()
    assert counts["partial_distance_update"] == counts["running_topk_update"] == 1
    assert counts["running_topk_update_large_k"] == (1 if nprobe > 64 else 0)
    assert counts["partial_distance_update_ref"] == counts["running_topk_ref"] == 0
    assert torch.cuda.memory_allocated() == before
    within_rounding(got, assign_queries(index, q), cent, q, nprobe)
