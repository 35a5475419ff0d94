"""The port's device-resident executor: ``tests/test_executor.py``'s
parity and bucketing cases, run through ``repro_torch`` with the same
index given to both packages (``ivf_from_arrays``), plus tombstones,
warmup and the probe-width padding."""

import dataclasses

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import build_ivf as r_build
from repro.core import search_oracle as r_oracle
from repro.data import make_dataset, make_queries
from repro_torch.core import ivf_from_arrays, search_oracle
from repro_torch.serve import ExecutorConfig, SpmdExecutor
from test_executor import assert_matches_oracle


def _port(ref):
    return ivf_from_arrays(
        dataclasses.asdict(ref.cfg),
        dict(centers=ref.centers, x=ref.x, ids=ref.ids,
             cluster_of=ref.cluster_of, offsets=ref.offsets),
        device="cpu")


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=4000, dim=32, n_components=8, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=32, nprobe=6, topk=5, kmeans_iters=4)
    ref = r_build(ds.x, cfg)
    q = make_queries(ds, nq=64, skew=0.3, noise=0.2, seed=1)
    return ds, ref, _port(ref), q


def _executor(index, mesh=None, **kw):
    kw.setdefault("chunk", 128)
    kw.setdefault("qb_buckets", (8, 32))
    if mesh is not None:
        kw.setdefault("d_blocks", mesh[1])
    return SpmdExecutor(index, ExecutorConfig(**kw), mesh=mesh, device="cpu")


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_parity_vs_oracle(anns, prune, mesh):
    _, ref, idx, q = anns
    ex = _executor(idx, mesh=mesh, prune=prune)
    assert ex.prune is prune
    res = ex.search_batch(q[:32])
    assert res.stats["backend"] == "spmd" and res.stats["precision"] == "fp32"
    assert_matches_oracle(res, r_oracle(ref, q[:32]))
    assert_matches_oracle(res, search_oracle(idx, q[:32]))


def test_parity_small_tiles(anns):
    """Several skip-map tiles per call (tile 32 × 64), as the reference's
    interpret-mode case."""
    _, ref, idx, q = anns
    ex = _executor(idx, tile_m=32, tile_n=64, tile_k=32)
    res = ex.search_batch(q[:8])
    assert_matches_oracle(res, r_oracle(ref, q[:8]))
    assert res.stats["tile_total"] > 0


def test_parity_metric_ip():
    ds = make_dataset(nb=3000, dim=24, n_components=6, spread=0.6, seed=2)
    cfg = RCfg(dim=24, nlist=24, nprobe=5, topk=5, kmeans_iters=4, metric="ip")
    ref = r_build(ds.x, cfg)
    idx = _port(ref)
    q = make_queries(ds, nq=24, seed=3)
    ex = _executor(idx)
    assert ex.prune is False
    assert_matches_oracle(ex.search_batch(q), r_oracle(ref, q))
    ex2 = _executor(idx, mesh=(2, 2))
    assert_matches_oracle(ex2.search_batch(q), r_oracle(ref, q))


def test_batch_larger_than_biggest_bucket_splits(anns):
    _, ref, idx, q = anns
    ex = _executor(idx)
    res = ex.search_batch(q)
    assert res.ids.shape == (64, 5) and res.ids.dtype == np.int64
    assert res.stats["splits"] == 2
    assert len(res.stats["buckets"]) == 2
    assert_matches_oracle(res, r_oracle(ref, q))


def test_singleton_batch(anns):
    _, ref, idx, q = anns
    ex = _executor(idx)
    res = ex.search_batch(q[0])
    assert res.ids.shape == (1, 5)
    assert res.stats["pad_queries"] == ex.qb_buckets[0] - 1
    assert_matches_oracle(res, r_oracle(ref, q[:1]))


def test_empty_probe_set(anns):
    _, _, idx, q = anns
    ex = _executor(idx)
    res = ex.search_batch(q[:4], nprobe=0)
    assert (res.ids == -1).all()
    assert np.isinf(res.scores).all()
    assert ex.compiles == 0
    assert res.stats["buckets"] == []


def test_mixed_batch_sizes_compile_each_bucket_at_most_once(anns):
    _, _, idx, q = anns
    ex = _executor(idx)
    sizes = [3, 8, 20, 32, 1, 17, 32, 8]
    off = 0
    for n in sizes:
        ex.search_batch(q[off % 32: off % 32 + n])
        off += 7
    assert all(n == 1 for n in ex.trace_counts.values()), ex.trace_counts
    compiled = ex.compiles
    off = 0
    for n in sizes:
        res = ex.search_batch(q[off % 32: off % 32 + n])
        assert res.stats["compiled"] is False
        off += 7
    assert ex.compiles == compiled
    assert set(ex.trace_counts) == set(ex._steps)
    summary = ex.stats_summary()
    assert summary["compiles"] == compiled
    assert summary["dispatches"] == 2 * len(sizes)
    assert 0.0 <= summary["tile_skip_frac"] <= 1.0


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_dead_rows_match_oracle(anns, mesh):
    _, ref, idx, q = anns
    dead = np.random.default_rng(5).random(idx.nb) < 0.3
    ex = _executor(idx, mesh=mesh)
    res = ex.search_batch(q[:20], dead_rows=dead)
    assert_matches_oracle(res, r_oracle(ref, q[:20], dead_rows=dead))
    assert_matches_oracle(res, search_oracle(idx, q[:20], dead_rows=dead))
    alive_ids = set(idx.ids[~dead].tolist())
    assert set(res.ids[res.ids >= 0].tolist()) <= alive_ids


def test_warmup_builds_ladder_and_pads_probe_width(anns):
    _, ref, idx, q = anns
    ex = _executor(idx)
    ex.warmup(nprobe=(6, 9))
    n_steps = len(ex.qb_buckets) * len(ex.cap_buckets) * 2
    assert ex.compiles == n_steps
    res = ex.search_batch(q[:8])
    assert res.stats["compiled"] is False
    # an explicit narrower probe table is padded to a warmed width
    from repro_torch.core import assign_queries

    probes = assign_queries(idx, q[:8], 4)
    res4 = ex.search_batch(q[:8], probes=probes)
    assert res4.stats["compiled"] is False
    assert ex.compiles == n_steps
    assert_matches_oracle(res4, r_oracle(ref, q[:8], nprobe=4))
