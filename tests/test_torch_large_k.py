"""Served batches whose running top-K is above 256, the CUDA top-K
kernel's second route, against the JAX package (CPU): an fp32 server at
k = 300 (the ring's K and the merge's C = K = 300) and an int8 server at
k = 65 (the ring's K' = 4 · 65 = 260), on both backends, with a delta and
after a seal. The plain version runs here; on the card the same calls go
through ``running_topk_update``'s route 2."""

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import SegmentedIndex as RSegmented
from repro.data import make_dataset
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import HarmonyServer as RServer
from repro_torch.kernels import ops, topk_update
from repro_torch.serve import ExecutorConfig, HarmonyServer
from test_executor import assert_matches_oracle
from test_torch_segments import port_plane

DIM = 16


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=1200, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = RCfg(dim=DIM, nlist=8, nprobe=5, topk=5, kmeans_iters=3)
    rng = np.random.default_rng(1)
    q = (ds.x[rng.choice(ds.nb, 12, replace=False)]
         + 0.05 * rng.standard_normal((12, DIM))).astype(np.float32)
    return ds, cfg, q


@pytest.mark.parametrize("lifecycle", ["delta", "sealed"])
@pytest.mark.parametrize("backend", ["host", "spmd"])
@pytest.mark.parametrize("precision,k", [("fp32", 300), ("int8", 65)])
def test_large_k_server_matches_reference(anns, precision, k, backend, lifecycle):
    ds, cfg, q = anns
    ref = RSegmented.build(ds.x, cfg)
    rng = np.random.default_rng(2)
    ref.upsert(np.arange(5000, 5100), (ds.x[:100] + 0.02).astype(np.float32))
    ref.delete(rng.choice(ds.nb, 40, replace=False))
    if lifecycle == "sealed":
        ref.compact_inline()
        ref.upsert([9000], ds.x[5:6])
    ecfg = dict(qb_buckets=(8,), chunk=64)
    r = RServer(ref, n_nodes=4, backend=backend, precision=precision,
                executor_cfg=RExCfg(use_pallas=False, **ecfg))
    t = HarmonyServer(port_plane(ref), n_nodes=4, backend=backend, precision=precision,
                      executor_cfg=ExecutorConfig(**ecfg), device="cpu")
    ops.reset_launch_counts()
    tr, rr = t.search_batch(q, k=k), r.search_batch(q, k=k)
    assert tr.ids.shape == (12, k)
    assert_matches_oracle(tr, rr)
    if precision == "fp32":
        assert ((tr.ids >= 0).sum(1) > 256).all()
    if backend == "spmd":
        # the ring's K (K' = 4 k for int8) takes route 2 on the card; here
        # the plain version, as on every CPU tensor
        ring_k = k if precision == "fp32" else 4 * k
        assert topk_update.route(ring_k) == 2
        ex = t._seg_states[0].executors[precision]
        assert all(key[2] == ring_k for key in ex.trace_counts)
        assert ops.launch_counts()["running_topk_ref"] > 0
        assert ops.launch_counts()["running_topk_update"] == 0


@pytest.mark.parametrize("precision,k", [("fp32", 12289), ("int8", 3073)])
def test_huge_k_server_matches_reference(precision, k):
    """k above the top-K kernel's route 2 (K > 12288: route 3 on the card):
    an fp32 spmd server at k = 12289, and an int8 one at k = 3073 over
    12400 rows, whose ring runs at K' = 4 · 3073 = 12292, answer as the
    reference's do on a plane with tombstones. Then a delta (two parts in
    the fused merge at C = K = k): equal to the exact top-k over the live
    set. (The reference's fused merge runs its Pallas kernel in interpret
    mode on the CPU, minutes at this K, so the two-part case is held
    against the brute force.) Every probe is taken, so search is exact."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((12400, 8)).astype(np.float32)
    cfg = RCfg(dim=8, nlist=8, nprobe=8, topk=5, kmeans_iters=2)
    ref = RSegmented.build(x, cfg)
    ref.delete(rng.choice(12400, 30, replace=False))
    q = (x[:2] + 0.05 * rng.standard_normal((2, 8))).astype(np.float32)
    ecfg = dict(qb_buckets=(8,), chunk=256)
    r = RServer(ref, n_nodes=2, backend="spmd", precision=precision,
                executor_cfg=RExCfg(use_pallas=False, **ecfg))
    t = HarmonyServer(port_plane(ref), n_nodes=2, backend="spmd", precision=precision,
                      executor_cfg=ExecutorConfig(**ecfg), device="cpu")
    ops.reset_launch_counts()
    tr, rr = t.search_batch(q, k=k), r.search_batch(q, k=k)
    assert tr.ids.shape == (2, k) and (tr.ids >= 0).all()
    assert_matches_oracle(tr, rr)
    ring_k = k if precision == "fp32" else 4 * k
    assert topk_update.route(ring_k) == 3
    ex = t._seg_states[0].executors[precision]
    assert all(key[2] == ring_k for key in ex.trace_counts)
    assert ops.launch_counts()["running_topk_ref"] > 0
    assert ops.launch_counts()["running_topk_update"] == 0
    t.upsert(np.arange(20_000, 20_050), (x[:50] + 0.01).astype(np.float32))
    res = t.search_batch(q, k=k)
    live_ids, live_x = t.data.live_vectors()
    d = ((q[:, None, :].astype(np.float64) - live_x[None].astype(np.float64)) ** 2).sum(2)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_allclose(res.scores, np.take_along_axis(d, order, 1),
                               rtol=1e-3, atol=1e-3)
    if precision == "fp32":
        assert (np.sort(res.ids, 1) == np.sort(live_ids[order], 1)).mean() > 0.999
