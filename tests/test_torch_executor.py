"""The port's device-resident executor: ``tests/test_executor.py``'s
parity and bucketing cases, run through ``repro_torch`` with the same
index given to both packages (``ivf_from_arrays``), plus tombstones,
warmup and the probe-width padding; and the int8 tier
(``tests/test_quantization.py``'s executor cases) against the reference's
int8 executor."""

import dataclasses

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import build_ivf as r_build
from repro.core import search_oracle as r_oracle
from repro.data import make_dataset, make_queries
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import SpmdExecutor as RExecutor
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


def _recall(ids, ref_ids):
    k = ref_ids.shape[1]
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(ids, ref_ids)])


def _assert_exact_fp32_scores(idx, q, res):
    """Every returned id carries its exact fp32 distance; ids are distinct."""
    pos = {int(e): r for r, e in enumerate(idx.ids)}
    x = idx.x.numpy().astype(np.float64)
    for i in range(len(q)):
        ok = res.ids[i] >= 0
        row_ids = res.ids[i][ok]
        assert len(set(row_ids.tolist())) == len(row_ids)
        rows = [pos[int(e)] for e in row_ids]
        want = ((x[rows] - q[i].astype(np.float64)) ** 2).sum(1)
        np.testing.assert_allclose(res.scores[i][ok], want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_int8_matches_reference_executor(anns, mesh):
    _, ref, idx, q = anns
    kw = dict(chunk=128, qb_buckets=(8, 32), precision="int8")
    if mesh is not None:
        kw["d_blocks"] = mesh[1]
    ex8 = _executor(idx, mesh=mesh, **kw)
    r8 = ex8.search_batch(q[:32])
    assert r8.stats["precision"] == "int8"
    assert r8.stats["rerank_k"] == ref.cfg.topk * ex8.cfg.rerank_factor
    if mesh is None:   # the reference's 2×2 mesh needs four JAX devices
        want = RExecutor(ref, RExCfg(**kw)).search_batch(q[:32])
        assert want.stats["rerank_k"] == r8.stats["rerank_k"]
        assert_matches_oracle(r8, want)
    # recall against fp32 and exact fp32 scores, on either mesh
    r32 = _executor(idx, mesh=mesh).search_batch(q[:32])
    assert _recall(r8.ids, r32.ids) >= 0.98
    _assert_exact_fp32_scores(idx, q[:32], r8)
    for i in range(32):
        m = dict(zip(r32.ids[i].tolist(), r32.scores[i].tolist()))
        for j, e in enumerate(r8.ids[i].tolist()):
            if e in m:
                np.testing.assert_allclose(r8.scores[i, j], m[e], rtol=1e-3, atol=1e-3)


def test_int8_dead_rows_and_split(anns):
    _, ref, idx, q = anns
    ex = _executor(idx, precision="int8", qb_buckets=(8,))
    base = ex.search_batch(q[:1])
    dead = np.zeros(idx.nb, bool)
    order = np.argsort(idx.ids, kind="stable")
    top = base.ids[0, 0]
    dead[order[np.searchsorted(idx.ids[order], top)]] = True
    res = ex.search_batch(q[:1], dead_rows=dead)
    assert top not in res.ids[0]
    rex = RExecutor(ref, RExCfg(chunk=128, qb_buckets=(8,), precision="int8"))
    assert_matches_oracle(res, rex.search_batch(q[:1], dead_rows=dead))
    # a batch above the biggest bucket splits and still re-ranks each part
    big = ex.search_batch(q[:48])          # 48 queries through qb=8 buckets
    assert big.stats["splits"] == 6
    assert big.stats["precision"] == "int8"
    assert big.stats["rerank_k"] == ref.cfg.topk * ex.cfg.rerank_factor
    assert _recall(big.ids, _executor(idx).search_batch(q[:48]).ids) >= 0.98


def test_int8_warmup_covers_explicit_probe_widths(anns):
    _, _, idx, q = anns
    from repro_torch.core import assign_queries

    ex = _executor(idx, precision="int8")
    ex.warmup(nprobe=[4, idx.cfg.nprobe])
    warmed = ex.compiles
    assert warmed == len(ex.qb_buckets) * len(ex.cap_buckets) * 2
    assert all(key[2] == ex._k_step(ex.k) for key in ex.trace_counts)
    ex.search_batch(q, probes=assign_queries(idx, q, 4))
    assert ex.compiles == warmed
    probes2 = assign_queries(idx, q, 2)
    res = ex.search_batch(q, probes=probes2)
    assert ex.compiles == warmed
    want = _executor(idx, precision="int8").search_batch(q, probes=probes2)
    assert np.array_equal(res.ids, want.ids)
    np.testing.assert_allclose(res.scores, want.scores, rtol=1e-5)


def test_int8_tiny_corpus_pads_to_k():
    """K' = min(k·rerank_factor, nb) < k: the re-rank pads to k."""
    ds = make_dataset(nb=7, dim=8, n_components=2, spread=0.6, seed=4)
    cfg = RCfg(dim=8, nlist=2, nprobe=2, topk=10, kmeans_iters=2)
    ref = r_build(ds.x, cfg)
    idx = _port(ref)
    q = make_queries(ds, nq=3, seed=5)
    kw = dict(chunk=8, qb_buckets=(8,), precision="int8")
    res = _executor(idx, **kw).search_batch(q)
    want = RExecutor(ref, RExCfg(**kw)).search_batch(q)
    assert res.stats["rerank_k"] == want.stats["rerank_k"] == 7
    assert res.ids.shape == (3, 10) and (res.ids[:, 7:] == -1).all()
    assert np.isinf(res.scores[:, 7:]).all()
    assert_matches_oracle(res, want)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_ids_beyond_int32(anns, precision, mesh):
    """The ring carries packed row positions, so external ids beyond int32
    come back exact: the same index under ids shifted past 2^31 gives the
    same rows and scores, through the int8 re-rank too."""
    _, ref, idx, q = anns
    shift = 3_000_000_000
    big = ivf_from_arrays(
        dataclasses.asdict(ref.cfg),
        dict(centers=ref.centers, x=ref.x, ids=ref.ids + shift,
             cluster_of=ref.cluster_of, offsets=ref.offsets),
        device="cpu")
    dead = np.zeros(idx.nb, bool)
    dead[::7] = True
    got = _executor(big, mesh=mesh, precision=precision).search_batch(q[:40], dead_rows=dead)
    want = _executor(idx, mesh=mesh, precision=precision).search_batch(q[:40], dead_rows=dead)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.ids, np.where(want.ids >= 0, want.ids + shift, -1))
    assert (got.ids >= shift).all()
