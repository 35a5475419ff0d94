"""The port's host engine, planner, cost model, routing helpers, elastic
re-plan and cross-segment merges against the JAX package on the same
numpy inputs (CPU). Mirrors ``tests/test_search_engine.py`` through the
port: ``harmony_search`` over the same index and plan in both packages,
across modes, node counts, pruning, the non-pipelined dispatch and
tombstones."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.cost_model as r_cost
import repro.core.router as r_router
import repro_torch.core.cost_model as t_cost
import repro_torch.core.router as t_router
from repro.config import HarmonyConfig as RCfg
from repro.core import (
    TopKHeap as RHeap,
    build_ivf as r_build,
    delta_topk as r_delta_topk,
    harmony_search as r_harmony,
    merge_topk as r_merge,
    partial_scores_block as r_partial,
    plan_search as r_plan,
    preassign as r_preassign,
    search_oracle as r_oracle,
)
from repro.data import make_dataset, make_queries
from repro.runtime import ClusterState as RCluster
from repro.runtime import replan_on_failure as r_replan
from repro_torch.config import HarmonyConfig
from repro_torch.core import (
    PartitionPlan,
    TopKHeap,
    delta_topk,
    harmony_search,
    ivf_from_arrays,
    merge_topk,
    partial_scores_block,
    plan_search,
    preassign,
    search_oracle,
)
from repro_torch.kernels import ref as kref
from repro_torch.runtime import ClusterState, replan_on_failure
from test_executor import assert_matches_oracle


def _port(ref):
    return ivf_from_arrays(
        dataclasses.asdict(ref.cfg),
        dict(centers=ref.centers, x=ref.x, ids=ref.ids,
             cluster_of=ref.cluster_of, offsets=ref.offsets),
        device="cpu")


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=4000, dim=32, n_components=12, seed=3)
    cfg = RCfg(dim=32, nlist=32, nprobe=6, topk=10, kmeans_iters=6)
    ref = r_build(ds.x, cfg)
    q = make_queries(ds, nq=48, skew=0.3, seed=7)
    return ds, ref, _port(ref), q


def _same_plan(tp, rp):
    assert (tp.v_shards, tp.d_blocks, tp.mode) == (rp.v_shards, rp.d_blocks, rp.mode)
    np.testing.assert_array_equal(tp.cluster_to_shard, rp.cluster_to_shard)
    np.testing.assert_array_equal(tp.ring_offsets, rp.ring_offsets)


def _port_corpus(idx, rplan):
    return preassign(idx, PartitionPlan(
        v_shards=rplan.v_shards, d_blocks=rplan.d_blocks,
        cluster_to_shard=rplan.cluster_to_shard,
        ring_offsets=rplan.ring_offsets, mode=rplan.mode))


# ------------------------------------------------------------------ planner


@pytest.mark.parametrize("mode", ["harmony", "vector", "dimension"])
@pytest.mark.parametrize("n_nodes", [1, 2, 4, 8])
@pytest.mark.parametrize("sampled", [False, True])
def test_plan_search_parity(anns, mode, n_nodes, sampled):
    _, ref, idx, q = anns
    sample = None
    if sampled:
        from repro.core import assign_queries
        sample = assign_queries(ref, q)
    kw = dict(probes_sample=sample)
    rd = r_plan(ref, n_nodes, ref.cfg.replace(mode=mode), **kw)
    td = plan_search(idx, n_nodes, HarmonyConfig(**dataclasses.asdict(ref.cfg)).replace(mode=mode), **kw)
    _same_plan(td.plan, rd.plan)
    assert [c[0] for c in td.candidates] == [c[0] for c in rd.candidates]
    np.testing.assert_allclose([c[1] for c in td.candidates],
                               [c[1] for c in rd.candidates], rtol=1e-9)
    assert td.cost.keys() == rd.cost.keys()
    for key in rd.cost:
        np.testing.assert_allclose(td.cost[key], rd.cost[key], rtol=1e-9)
    assert td.hot_mass == pytest.approx(rd.hot_mass, rel=1e-12)


def test_planner_options_parity(anns):
    _, ref, idx, _ = anns
    tcfg = HarmonyConfig(**dataclasses.asdict(ref.cfg))
    surv = np.array([1.0, 0.5, 0.2, 0.1])
    for kw in (dict(balanced=False), dict(stagger=False), dict(survival=surv),
               dict(hw=t_cost.HardwareModel(flops_rate=1e12, net_bw=1e9))):
        rkw = dict(kw)
        if "hw" in kw:
            rkw["hw"] = r_cost.HardwareModel(flops_rate=1e12, net_bw=1e9)
        rd, td = r_plan(ref, 4, ref.cfg, **rkw), plan_search(idx, 4, tcfg, **kw)
        _same_plan(td.plan, rd.plan)
        np.testing.assert_allclose(td.cost["cost"], rd.cost["cost"], rtol=1e-9)
    with pytest.raises(ValueError, match="mode"):
        plan_search(idx, 4, tcfg, mode="nope")


def test_cost_model_parity():
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 500, size=40).astype(float)
    hits = rng.integers(0, 9, size=40).astype(float)
    for V, B in ((4, 1), (2, 2), (1, 4)):
        assign = rng.integers(0, V, size=40).astype(np.int32)
        rp = r_router.load_aware_assignment(sizes, hits, V)
        tp = t_router.load_aware_assignment(sizes, hits, V)
        np.testing.assert_array_equal(tp, rp)
        for surv in (None, np.array([1.0, 0.6, 0.3, 0.1])):
            rw = r_cost.WorkloadStats(sizes, hits, dim=64, nq=50, topk=10, survival=surv)
            tw = t_cost.WorkloadStats(sizes, hits, dim=64, nq=50, topk=10, survival=surv)
            from repro.core.types import PartitionPlan as RPlan
            rplan = RPlan(V, B, assign)
            tplan = PartitionPlan(V, B, assign)
            for prune in (True, False):
                np.testing.assert_allclose(
                    t_cost.per_node_loads(tplan, tw, prune),
                    r_cost.per_node_loads(rplan, rw, prune), rtol=1e-12)
                rc = r_cost.plan_cost(rplan, rw, enable_pruning=prune, alpha=0.5)
                tc = t_cost.plan_cost(tplan, tw, enable_pruning=prune, alpha=0.5)
                assert tc.keys() == rc.keys()
                for key in rc:
                    np.testing.assert_allclose(tc[key], rc[key], rtol=1e-12)
            assert t_cost.imbalance(tplan, tw, t_cost.HardwareModel()) == pytest.approx(
                r_cost.imbalance(rplan, rw, r_cost.HardwareModel()), rel=1e-12)
    assert (dataclasses.asdict(t_cost.HardwareModel())
            == dataclasses.asdict(r_cost.HardwareModel()))


def test_router_workload_helpers_parity():
    rng = np.random.default_rng(1)
    probes = rng.integers(-1, 30, size=(64, 5))
    np.testing.assert_array_equal(t_router.estimate_cluster_hits(probes, 30),
                                  r_router.estimate_cluster_hits(probes, 30))
    for v in (1, 3, 7):
        np.testing.assert_array_equal(t_router.round_robin_assignment(30, v),
                                      r_router.round_robin_assignment(30, v))
    hits = r_router.estimate_cluster_hits(probes, 30)
    for frac in (0.05, 0.1, 0.5):
        assert t_router.workload_concentration(hits, frac) == \
            r_router.workload_concentration(hits, frac)
    assert t_router.workload_concentration(np.zeros(5)) == 0.0
    assert t_router.DEFAULT_HOT_FRACTION == r_router.DEFAULT_HOT_FRACTION


def test_elastic_replan_parity(anns):
    _, ref, idx, _ = anns
    rs, ts = RCluster.fresh(4), ClusterState.fresh(4)
    for st in (rs, ts):
        st.fail(1)
        st.join()
        st.fail(3)
    assert (ts.n_nodes, ts.n_live) == (rs.n_nodes, rs.n_live)
    np.testing.assert_array_equal(ts.live_ids(), rs.live_ids())
    rd, rc = r_replan(ref, rs)
    td, tc = replan_on_failure(idx, ts)
    _same_plan(td.plan, rd.plan)
    np.testing.assert_array_equal(tc.ids_shard, rc.ids_shard)
    dead = ClusterState.fresh(1)
    dead.fail(0)
    with pytest.raises(RuntimeError, match="no live nodes"):
        replan_on_failure(idx, dead)


# -------------------------------------------------------------- host engine


def _engine_pair(anns, mode, n_nodes, **kw):
    _, ref, idx, q = anns
    rd = r_plan(ref, n_nodes, ref.cfg.replace(mode=mode))
    rres = r_harmony(ref, r_preassign(ref, rd.plan), q, **kw)
    tres = harmony_search(idx, _port_corpus(idx, rd.plan), q, **kw)
    return ref, idx, q, rres, tres


@pytest.mark.parametrize("mode", ["harmony", "vector", "dimension"])
@pytest.mark.parametrize("n_nodes", [1, 2, 4])
def test_harmony_search_matches_reference(anns, mode, n_nodes):
    ref, idx, q, rres, tres = _engine_pair(anns, mode, n_nodes)
    assert_matches_oracle(tres, rres)
    assert_matches_oracle(tres, r_oracle(ref, q))
    assert tres.ids.dtype == np.int64 and tres.scores.dtype == np.float32
    for key in ("visits", "stages", "dense_flops"):
        assert tres.stats[key] == rres.stats[key], key


@pytest.mark.parametrize("prune", [True, False])
def test_harmony_search_pruning_exact(anns, prune):
    ref, idx, q, rres, tres = _engine_pair(anns, "dimension", 4,
                                           enable_pruning=prune)
    assert_matches_oracle(tres, rres)
    assert_matches_oracle(tres, search_oracle(idx, q))
    if not prune:
        assert tres.stats["pair_flops"] == rres.stats["pair_flops"]
        assert tres.stats["slice_pruned_ratio"] == rres.stats["slice_pruned_ratio"]
    else:
        off = harmony_search(idx, _port_corpus(idx, r_plan(
            ref, 4, ref.cfg.replace(mode="dimension")).plan), q, enable_pruning=False)
        assert tres.stats["pair_flops"] < off.stats["pair_flops"]


def test_harmony_search_pipeline_off(anns):
    ref, idx, q, rres, tres = _engine_pair(anns, "harmony", 4, pipeline=False)
    assert_matches_oracle(tres, rres)
    assert tres.stats["stages"] == rres.stats["stages"] == 1


def test_harmony_search_dead_rows_and_probes(anns):
    _, ref, idx, q = anns
    dead = np.random.default_rng(4).random(ref.nb) < 0.3
    rd = r_plan(ref, 4, ref.cfg)
    rc, tc = r_preassign(ref, rd.plan), _port_corpus(idx, rd.plan)
    from repro.core import assign_queries
    probes = assign_queries(ref, q, 10)
    rres = r_harmony(ref, rc, q, dead_rows=dead, dead_key=(0, 1), probes=probes)
    tres = harmony_search(idx, tc, q, dead_rows=dead, dead_key=(0, 1), probes=probes)
    assert_matches_oracle(tres, rres)
    assert not np.isin(tres.ids, ref.ids[dead]).any()
    # the (generation, dead_version) key caches the shard remap
    m1 = tc.dead_shard_mask(dead, key=(0, 1))
    assert tc.dead_shard_mask(np.zeros_like(dead), key=(0, 1)) is m1
    np.testing.assert_array_equal(m1, rc.dead_shard_mask(dead))
    assert not tc.dead_shard_mask(dead, key=(0, 2)) is m1


# ------------------------------------------------------------------- merges


def test_topk_heap_and_partial_scores_parity():
    rng = np.random.default_rng(5)
    rh, th = RHeap.empty(6, 4), TopKHeap.empty(6, 4)
    np.testing.assert_array_equal(th.tau, rh.tau)
    for _ in range(3):
        rows = rng.choice(6, size=4, replace=False)
        s = np.round(rng.uniform(0, 9, size=(4, 7))).astype(np.float32)
        s[rng.random((4, 7)) < 0.2] = np.inf
        ids = rng.integers(0, 100, size=(4, 7))
        rh.merge_rows(rows, s, ids)
        th.merge_rows(rows, s, ids)
        np.testing.assert_array_equal(th.scores, rh.scores)
        np.testing.assert_array_equal(th.ids, rh.ids)
    th.merge_rows(np.zeros(0, np.int64), np.zeros((0, 3), np.float32), np.zeros((0, 3)))
    np.testing.assert_array_equal(th.scores, rh.scores)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    qv = rng.normal(size=(3, 8)).astype(np.float32)
    xn = (x * x).sum(1)
    for metric in ("l2", "ip"):
        np.testing.assert_array_equal(partial_scores_block(x, qv, xn, metric),
                                      r_partial(x, qv, xn, metric))
    with pytest.raises(ValueError):
        partial_scores_block(x, qv, xn, "cos")


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_live", [0, 3, 40])
def test_delta_topk_parity(metric, n_live):
    rng = np.random.default_rng(n_live)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.permutation(1000)[:50].astype(np.int64)
    live = np.zeros(50, bool)
    live[rng.choice(50, size=n_live, replace=False)] = True
    qv = rng.normal(size=(9, 16)).astype(np.float32)
    ws, wi = r_delta_topk(x, ids, live, qv, 5, metric)
    gs, gi = delta_topk(x, ids, live, qv, 5, metric, device="cpu")
    assert gs.shape == (9, 5) and gi.dtype == np.int64
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gi, wi)
    assert not np.isin(gi[gi >= 0], ids[~live]).any()


def _parts(rng, nq, k, n_parts, ties, big_ids=False):
    out = []
    for p in range(n_parts):
        s = rng.uniform(0, 20, size=(nq, k))
        if ties:
            s = np.round(s / 4)
        s = np.sort(s.astype(np.float32), axis=1)
        s[:, k - 1 - p % k:] = np.inf          # short parts, +inf padded
        ids = rng.integers(0, 50_000, size=(nq, k)).astype(np.int64)
        ids[~np.isfinite(s)] = -1
        if big_ids and p == n_parts - 1:
            ids[:, 0] = 3_000_000_000 + np.arange(nq)
        out.append((s, ids))
    return out


@pytest.mark.parametrize("nq,k,n_parts", [(1, 10, 1), (7, 10, 3), (16, 5, 4), (9, 20, 2)])
@pytest.mark.parametrize("ties", [False, True])
def test_merge_topk_fused_bit_equal_to_reference(nq, k, n_parts, ties):
    """The fused merge against the reference's fused merge (its Pallas
    kernel in interpret mode): equal scores bit for bit, equal ids, ties
    across parts included (the earlier part wins)."""
    parts = _parts(np.random.default_rng(nq * k + n_parts), nq, k, n_parts, ties)
    kref.running_topk_ref.calls = 0
    gs, gi = merge_topk(parts, k, fused=True, device="cpu")
    assert kref.running_topk_ref.calls == n_parts   # one fold per part, in order
    ws, wi = r_merge(parts, k, fused=True)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)
    assert gi.dtype == np.int64 and gs.dtype == np.float32
    # the host merge holds the same scores; ids equal but for ties
    hs, hi = merge_topk(parts, k)
    rhs, rhi = r_merge(parts, k)
    np.testing.assert_array_equal(hs, rhs)
    np.testing.assert_array_equal(hi, rhi)
    np.testing.assert_array_equal(hs, gs)
    if not ties:
        np.testing.assert_array_equal(hi, gi)


def test_merge_topk_int32_gate_and_limits():
    """Ids beyond int32 need no gate: the fused merge carries columns and
    gathers the int64 ids afterwards, so it folds every part on the kernel
    and gives what it gives on small ids, ties included."""
    rng = np.random.default_rng(11)
    parts = _parts(rng, 6, 10, 3, ties=False, big_ids=True)
    kref.running_topk_ref.calls = 0
    gs, gi = merge_topk(parts, 10, fused=True, device="cpu")
    assert kref.running_topk_ref.calls == 3        # int64 ids: still one fold a part
    ws, wi = r_merge(parts, 10, fused=True)        # the reference's host merge
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)
    assert (gi >= 3_000_000_000).any()
    tied = _parts(np.random.default_rng(12), 6, 10, 3, ties=True, big_ids=True)
    small = [(s, np.where(i >= 3_000_000_000, i - 3_000_000_000 + 60_000, i))
             for s, i in tied]
    gs, gi = merge_topk(tied, 10, fused=True, device="cpu")
    ss, si = merge_topk(small, 10, fused=True, device="cpu")
    np.testing.assert_array_equal(gs, ss)
    np.testing.assert_array_equal(np.where(gi >= 3_000_000_000,
                                           gi - 3_000_000_000 + 60_000, gi), si)
    kref.running_topk_ref.calls = 0
    # K beyond the top-K kernel's limit raises before any launch, on any device
    big = [(np.zeros((2, 257), np.float32), np.zeros((2, 257), np.int64))]
    with pytest.raises(ValueError, match="256"):
        merge_topk(big, 257, fused=True, device="cpu")
    assert kref.running_topk_ref.calls == 0
    s, i = merge_topk(big, 257)                    # the host merge takes any K
    assert s.shape == (2, 257)
    with pytest.raises(ValueError):
        merge_topk([], 5)


@pytest.mark.cuda
def test_cuda_merge_and_engine_match_cpu(anns):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    parts = _parts(np.random.default_rng(3), 160, 20, 3, ties=True)
    gs, gi = merge_topk(parts, 20, fused=True, device="cuda")
    ws, wi = merge_topk(parts, 20, fused=True, device="cpu")
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)
    ds, ref, _, q = anns
    idx = ivf_from_arrays(dataclasses.asdict(ref.cfg), dict(
        centers=ref.centers, x=ref.x, ids=ref.ids, cluster_of=ref.cluster_of,
        offsets=ref.offsets), device="cuda")
    plan = r_plan(ref, 4, ref.cfg).plan
    assert_matches_oracle(harmony_search(idx, _port_corpus(idx, plan), q),
                          r_oracle(ref, q))
