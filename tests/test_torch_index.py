"""The port's index build, sharded layout, probe selection, τ prewarm and
oracle against the JAX package, on the same arrays (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import (
    PartitionPlan as RPlan,
    assign_queries as r_assign,
    build_ivf as r_build,
    preassign as r_preassign,
    prewarm_tau as r_prewarm,
    search_oracle as r_oracle,
)
from repro.data import make_dataset, make_queries
from repro_torch.config import HarmonyConfig
from repro_torch.core import (
    PartitionPlan,
    assign_queries,
    build_ivf,
    ivf_from_arrays,
    preassign,
    prewarm_tau,
    search_oracle,
)
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.data import brute_force_topk, recall_at_k


def port_index(ref_index, device="cpu"):
    """The same index in the port, through ``ivf_from_arrays``."""
    return ivf_from_arrays(
        dataclasses.asdict(ref_index.cfg),
        dict(centers=ref_index.centers, x=ref_index.x, ids=ref_index.ids,
             cluster_of=ref_index.cluster_of, offsets=ref_index.offsets),
        device=device,
    )


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=3000, dim=32, n_components=8, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=24, nprobe=5, topk=5, kmeans_iters=4)
    ref = r_build(ds.x, cfg)
    q = make_queries(ds, nq=40, skew=0.3, noise=0.2, seed=1)
    return ds, ref, port_index(ref), q


def test_build_from_reference_centers_is_byte_identical(anns):
    ds, ref, _, _ = anns
    cfg = HarmonyConfig(**dataclasses.asdict(ref.cfg))
    ext = np.arange(ds.nb, dtype=np.int64)[::-1] + 1000
    for ext_ids, want_ids in ((None, ref.ids), (ext, ext[ref.ids])):
        idx = build_ivf(ds.x, cfg, ext_ids=ext_ids, centers=ref.centers,
                        device="cpu")
        assert idx.x.numpy().tobytes() == ref.x.tobytes()
        np.testing.assert_array_equal(idx.ids, want_ids)
        assert idx.ids.dtype == np.int64
        np.testing.assert_array_equal(idx.cluster_of, ref.cluster_of)
        assert idx.cluster_of.dtype == ref.cluster_of.dtype
        np.testing.assert_array_equal(idx.offsets, ref.offsets)
        np.testing.assert_array_equal(idx.centers, ref.centers)


def test_ivf_from_arrays_properties(anns):
    _, ref, idx, _ = anns
    assert (idx.nb, idx.dim, idx.nlist) == (ref.nb, ref.dim, ref.nlist)
    np.testing.assert_array_equal(idx.sizes, ref.sizes)
    assert idx.cluster_rows(3) == ref.cluster_rows(3)
    np.testing.assert_allclose(idx.xnorm2.numpy(), ref.xnorm2, rtol=1e-6)
    assert idx.cfg == HarmonyConfig(**dataclasses.asdict(ref.cfg))
    again = ivf_from_arrays(idx.cfg, dict(centers=ref.centers, x=ref.x,
                                          ids=ref.ids, cluster_of=ref.cluster_of,
                                          offsets=ref.offsets), device="cpu")
    assert torch.equal(again.x, idx.x)


@pytest.mark.parametrize("V,B", [(1, 1), (1, 2), (2, 2), (4, 2), (3, 4)])
def test_preassign_layout_parity(anns, V, B):
    _, ref, idx, _ = anns
    c2s = load_aware_assignment(idx.sizes, None, V)
    offs = ring_offsets(V, B)
    rc = r_preassign(ref, RPlan(v_shards=V, d_blocks=B, cluster_to_shard=c2s,
                                ring_offsets=offs), pad_to=64)
    tc = preassign(idx, PartitionPlan(v_shards=V, d_blocks=B,
                                      cluster_to_shard=c2s, ring_offsets=offs),
                   pad_to=64)
    assert tc.cap == rc.cap
    assert tc.x_shard.numpy().tobytes() == rc.x_shard.tobytes()
    for name in ("ids_shard", "cluster_shard", "valid", "packed_shard",
                 "packed_row"):
        a, b = getattr(tc, name), getattr(rc, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert tc.cluster_slices == rc.cluster_slices
    np.testing.assert_allclose(tc.xnorm2_blk.numpy(), rc.xnorm2_blk,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("nprobe", [None, 1, 9])
def test_assign_queries_equal(anns, nprobe):
    _, ref, idx, q = anns
    np.testing.assert_array_equal(assign_queries(idx, q, nprobe),
                                  r_assign(ref, q, nprobe))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dead", [False, True])
def test_prewarm_tau_parity(anns, metric, dead):
    _, ref, idx, q = anns
    probes = r_assign(ref, q)
    dead_rows = None
    if dead:
        dead_rows = np.random.default_rng(4).random(ref.nb) < 0.3
    for k in (1, 5, 30):
        want = r_prewarm(ref, q, probes, k, 4, metric, dead_rows=dead_rows)
        got = prewarm_tau(idx, q, probes, k, 4, metric, dead_rows=dead_rows)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3, atol=1e-3)
    empty = np.zeros((len(q), 0), np.int32)
    assert np.isinf(prewarm_tau(idx, q, empty, 5)).all()


@pytest.mark.parametrize("kw", [dict(), dict(k=3, nprobe=2), dict(nprobe=24)])
@pytest.mark.parametrize("dead", [False, True])
def test_search_oracle_parity(anns, kw, dead):
    from test_executor import assert_matches_oracle

    _, ref, idx, q = anns
    dead_rows = (np.random.default_rng(2).random(ref.nb) < 0.25) if dead else None
    want = r_oracle(ref, q, dead_rows=dead_rows, **kw)
    got = search_oracle(idx, q, chunk=16, dead_rows=dead_rows, **kw)
    assert got.ids.dtype == np.int64 and got.scores.dtype == np.float32
    assert got.ids.shape == want.ids.shape
    assert_matches_oracle(got, want)


def test_own_kmeans_recall_at_quickstart_settings():
    """The port's k-means (numpy-seeded, so not the reference's centers),
    judged on recall@10 of the exact IVF scan against brute force, at the
    README quickstart's settings shrunk to test size."""
    ds = make_dataset(nb=4000, dim=32, n_components=16, spread=0.6, seed=0)
    cfg = HarmonyConfig(dim=32, nlist=32, nprobe=8, topk=10)
    idx = build_ivf(ds.x, cfg, device="cpu")
    assert idx.offsets[-1] == ds.nb and (np.diff(idx.cluster_of) >= 0).all()
    np.testing.assert_array_equal(np.sort(idx.ids), np.arange(ds.nb))
    again = build_ivf(ds.x, cfg, device="cpu")
    np.testing.assert_array_equal(again.centers, idx.centers)
    q = make_queries(ds, nq=64, skew=0.3, noise=0.2, seed=1)
    res = search_oracle(idx, q)
    true_idx, true_s = brute_force_topk(ds.x, q, 10, device="cpu")
    assert recall_at_k(res.ids, true_idx) >= 0.9
    # brute_force_topk agrees with the reference's ground truth
    from repro.data import brute_force_topk as r_bf

    r_idx, r_s = r_bf(ds.x, q, 10)
    np.testing.assert_allclose(true_s, r_s, rtol=1e-4, atol=1e-4)
    assert recall_at_k(true_idx, r_idx) >= 0.99


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_scores_parity(anns, metric):
    from repro.core.pruning import exact_scores as r_exact
    from repro_torch.core import exact_scores

    _, ref, idx, q = anns
    got = exact_scores(idx.x[:500], torch.from_numpy(q), metric)
    want = r_exact(ref.x[:500], q, metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        exact_scores(idx.x[:5], torch.from_numpy(q), "cos")
