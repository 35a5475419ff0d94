"""The port's tier placement policy and the plane's memory accounting
(CPU): mirrors of ``tests/test_tiered.py``'s policy, lifecycle and
hotness cases through ``repro_torch`` (the scheduler's lookahead comes
with the serving plane), and the reference held against the port: equal
plans on the same hotness and budget, and equal memory reports."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SegmentedIndex as RSegmented
from repro.serve import PlacementConfig as RPlacementConfig
from repro.serve import device_bytes_by_segment as r_device_bytes
from repro.serve import placement as r_placement
from repro.serve import plan_placement as r_plan
from repro_torch.checkpoint import Checkpointer, load_segmented_index, save_segmented_index
from repro_torch.config import HarmonyConfig
from repro_torch.core import SegmentedIndex, segment_bm25
from repro_torch.core.index import prewarm_table_bytes
from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault, fault_scope
from repro_torch.serve import (
    CompactionConfig,
    Compactor,
    HarmonyServer,
    PlacementConfig,
    apply_placement,
    device_bytes_by_segment,
    plan_placement,
)
from test_torch_segments import port_plane

CFG = HarmonyConfig(dim=16, nlist=8, nprobe=4, topk=5, kmeans_iters=3)


def _plane(seed=0, nb=384, extra=192, cfg=CFG):
    """Two sealed segments (build + sealed delta) with ids = row order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb + extra, cfg.dim)).astype(np.float32)
    data = SegmentedIndex.build(x[:nb], cfg, device="cpu")
    if extra:
        data.upsert(np.arange(nb, nb + extra), x[nb:])
        data.compact_inline()
    return x, data


def _queries(x, n=12, seed=3):
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(x), n)
    return x[picks] + 0.05 * rng.standard_normal((n, x.shape[1])).astype(np.float32)


def _server(data, backend="spmd"):
    return HarmonyServer(data, n_nodes=2, backend=backend, device="cpu")


# ------------------------------------------------------------------ policy
def test_plan_placement_no_budget_is_all_device():
    _, data = _plane()
    assert set(plan_placement(data, PlacementConfig()).values()) == {"device"}


def test_plan_placement_budget_keeps_hottest():
    _, data = _plane()
    sids = [s.seg_id for s in data.segments]
    data.note_probes(sids[1], np.array([[0, 1, 2, 3]]))
    budget = device_bytes_by_segment(data)[sids[1]]
    tiers = plan_placement(data, PlacementConfig(device_budget_bytes=budget))
    assert tiers[sids[1]] == "device" and tiers[sids[0]] == "host"


def test_plan_placement_hysteresis_is_sticky():
    # equal sizes: equal costs (without pruning, so without the τ prewarm's
    # sample table, whose size follows the lists')
    _, data = _plane(nb=192, extra=192, cfg=CFG.replace(enable_pruning=False))
    s0, s1 = [s.seg_id for s in data.segments]
    costs = device_bytes_by_segment(data)
    assert costs[s0] == costs[s1]
    data.set_tiers({s0: "device", s1: "host"})
    data.note_probes(s0, np.zeros((1, 20), np.int64))
    data.note_probes(s1, np.zeros((1, 21), np.int64))     # 5 % hotter: no flap
    cfg = PlacementConfig(device_budget_bytes=costs[s0])
    assert plan_placement(data, cfg) == {s0: "device", s1: "host"}
    data.note_probes(s1, np.zeros((1, 200), np.int64))
    assert plan_placement(data, cfg) == {s0: "host", s1: "device"}


def test_set_tiers_validates_and_bumps_version():
    _, data = _plane()
    v0 = data.placement_version
    sid = data.segments[0].seg_id
    assert data.set_tiers({sid: "host"}) == v0 + 1
    assert data.tier_of(sid) == "host"
    data.set_tiers({9999: "host"})       # unknown id ignored
    assert data.tiers().get(9999) is None and data.tier_of(9999) == "device"
    with pytest.raises(ValueError, match="unknown tier"):
        data.set_tiers({sid: "warm"})


def test_memory_report_per_tier():
    _, data = _plane()
    rep = data.memory_report()
    assert rep["device_bytes"] > 0 and rep["host_bytes"] > 0
    assert data.memory_bytes() == rep["host_bytes"] + rep["device_bytes"]
    rep8 = data.memory_report(precision="int8")
    assert rep8["device_bytes"] < rep["device_bytes"]
    data.set_tiers({s.seg_id: "host" for s in data.segments})
    cold = data.memory_report()
    assert cold["device_bytes"] == 0 and cold["host_bytes"] == rep["host_bytes"]


def test_memory_report_counts_metadata_and_bm25():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((128, CFG.dim)).astype(np.float32)
    base = SegmentedIndex.build(x, CFG, device="cpu").memory_report()["host_bytes"]
    data2 = SegmentedIndex.build(x, CFG, device="cpu")
    data2.upsert(np.arange(128, 192), rng.standard_normal((64, CFG.dim)).astype(np.float32),
                 meta={"color": np.arange(64) % 3,
                       "text": [f"doc number {i}" for i in range(64)]})
    data2.compact_inline()
    rep = data2.memory_report()
    assert rep["host_bytes"] > base
    bm = segment_bm25(data2.segments[-1].index)
    assert bm is not None
    assert data2.memory_report()["host_bytes"] == rep["host_bytes"] + bm.memory_bytes()


# ----------------------------------------------------- against the reference
@pytest.mark.parametrize("precision,d_blocks", [("fp32", 1), ("int8", 2)])
def test_plans_and_reports_equal_the_reference(precision, d_blocks, monkeypatch):
    """The same plane, hotness and budget give the reference's costs,
    plans and memory reports, at every budget from nothing to all. The
    fp32 rows are host bytes in both packages: the port keeps
    ``IVFIndex.x`` on the host for every tier, as the reference does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    from repro.config import HarmonyConfig as RCfg

    ref = RSegmented.build(x[:300], RCfg(**CFG.__dict__))
    for lo in (300, 400, 450):            # three more sealed segments
        ref.upsert(np.arange(lo, lo + 50 + lo // 10), x[lo:lo + 50 + lo // 10])
        ref.compact_inline()
    data = port_plane(ref)
    for seg, rseg in zip(data.segments, ref.segments):
        if "_int8_quants" in rseg.index.__dict__:     # the seals' codes
            seg.index.int8_quant()
    probes = {sid: np.random.default_rng(sid).integers(-1, 8, size=(5, 4))
              for sid in (1, 3)}
    for plane in (data, ref):
        for sid, p in probes.items():
            plane.note_probes(sid, p)
        plane.set_tiers({2: "host"})
    assert data.segment_hotness() == ref.segment_hotness()
    # at fp32 the port's executor also keeps the τ prewarm's sample table
    # on the card, which the reference does not: its costs are the
    # reference's plus that table, and the plans are the reference's
    # knapsack over the port's costs
    extra = {s.seg_id: prewarm_table_bytes(s.index) if precision == "fp32" else 0
             for s in data.segments}
    assert (precision == "fp32") == (sum(extra.values()) > 0)
    r_costs = r_device_bytes(ref, precision, d_blocks)
    costs = device_bytes_by_segment(data, precision, d_blocks)
    assert costs == {sid: c + extra[sid] for sid, c in r_costs.items()}
    on_card = sum(b for sid, b in extra.items() if data.tier_of(sid) == "device")
    r_rep = ref.memory_report(precision, d_blocks)
    assert data.memory_report(precision, d_blocks) == {
        **r_rep, "device_bytes": r_rep["device_bytes"] + on_card,
        "total_bytes": r_rep["total_bytes"] + on_card}
    assert data.memory_bytes() == ref.memory_bytes() + sum(
        prewarm_table_bytes(s.index) for s in data.segments if data.tier_of(s.seg_id) == "device")
    monkeypatch.setattr(r_placement, "device_bytes_by_segment", lambda d, p, b: {
        sid: c + extra[sid] for sid, c in r_device_bytes(d, p, b).items()})
    total = sum(costs.values())
    for frac in (0.0, 0.1, 0.25, 0.5, 0.75, 1.0, None):
        budget = None if frac is None else int(frac * total)
        mine = plan_placement(data, PlacementConfig(budget, precision, d_blocks))
        theirs = r_plan(ref, RPlacementConfig(budget, precision, d_blocks))
        assert mine == theirs, frac


# ------------------------------------------------------------- lifecycles
def test_tier_moves_do_not_bump_generation():
    x, data = _plane()
    srv = _server(data)
    gen, swaps = srv.generation, srv.stats.generation_swaps
    assert apply_placement(data, [srv], {s.seg_id: "host" for s in data.segments})
    assert not apply_placement(data, [srv], data.tiers())     # already placed
    srv.search_batch(_queries(x))
    assert srv.generation == gen and srv.stats.generation_swaps == swaps
    assert srv.stats.placement_swaps == 1


def test_placement_survives_compaction():
    x, data = _plane()
    srv = _server(data)
    sids = [s.seg_id for s in data.segments]
    budget = device_bytes_by_segment(data)[sids[0]]
    comp = Compactor(data, srv, CompactionConfig(
        delta_threshold=16, placement=PlacementConfig(device_budget_bytes=budget)),
        device="cpu")
    data.note_probes(sids[0], np.array([[0, 1, 2, 3]]))
    ev = comp.maybe_place()
    assert ev is not None and ev["reason"] == "placement"
    assert data.tier_of(sids[1]) == "host"
    assert comp.maybe_place() is None                  # no drift: no move
    rng = np.random.default_rng(9)
    data.upsert(np.arange(2000, 2032), rng.standard_normal((32, CFG.dim)).astype(np.float32))
    ev = comp.maybe_compact()
    assert ev is not None and ev["placed"] in (True, False)
    assert set(data.tiers()) == {s.seg_id for s in data.segments}
    q = _queries(x)
    res = srv.search_batch(q)
    host = srv.search_batch(q, backend="host")
    assert np.array_equal(res.ids, host.ids)


def test_placement_survives_checkpoint_restore(tmp_path):
    x, data = _plane()
    sids = [s.seg_id for s in data.segments]
    data.note_probes(sids[0], np.array([[0, 1], [2, 3]]))
    data.set_tiers({sids[0]: "device", sids[1]: "host"})
    save_segmented_index(Checkpointer(tmp_path), data)
    data2 = load_segmented_index(Checkpointer(tmp_path), device="cpu")
    assert data2.tiers() == data.tiers()
    assert data2.placement_version == data.placement_version
    for sid in sids:
        np.testing.assert_allclose(data2.hotness(sid), data.hotness(sid))
    q = _queries(x)
    a, b = _server(data).search_batch(q), _server(data2).search_batch(q)
    assert b.stats["cold_segments"] == 1
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.scores, b.scores)


def test_crash_at_tier_swap_never_loses_a_segment():
    x, data = _plane()
    srv = _server(data)
    q = _queries(x)
    before = srv.search_batch(q)
    tiers = {s.seg_id: "host" for s in data.segments}
    with fault_scope(FaultPlan(FaultSpec("placement.swap"))):
        with pytest.raises(InjectedFault):
            apply_placement(data, [srv], tiers)
    assert data.tiers() == tiers                 # the swap itself committed
    assert srv._placement_version != data.placement_version
    after = srv.search_batch(q)                  # the next batch re-syncs
    assert np.array_equal(before.ids, after.ids)
    assert np.array_equal(before.scores, after.scores)
    assert after.stats["cold_segments"] == data.n_segments
    with fault_scope(FaultPlan(FaultSpec("placement.prepare"))):
        with pytest.raises(InjectedFault):
            apply_placement(data, [srv], {s.seg_id: "device" for s in data.segments})
    assert data.tiers() == tiers
    again = srv.search_batch(q)
    assert np.array_equal(before.ids, again.ids)


def test_engine_feeds_hotness():
    x, data = _plane()
    srv = _server(data, backend="host")
    assert all(v == 0.0 for v in data.segment_hotness().values())
    srv.search_batch(_queries(x))
    assert any(v > 0.0 for v in data.segment_hotness().values())


# ------------------------------------------------- the rows live on the host
def test_index_rows_stay_on_the_host_of_a_non_cpu_plane(tmp_path):
    """On a plane whose device is not the CPU (``meta`` stands in for the
    card) every sealed segment's ``IVFIndex.x`` and its norms are host
    tensors, through ``ivf_from_arrays``, ``from_arrays`` and a checkpoint
    restore; the engine accepts the plane."""
    from repro_torch.core import ivf_from_arrays

    x, data = _plane()
    arrays = dict(centers=data.segments[0].index.centers,
                  x=data.segments[0].index.x.numpy(),
                  ids=data.segments[0].index.ids,
                  cluster_of=data.segments[0].index.cluster_of,
                  offsets=data.segments[0].index.offsets)
    idx = ivf_from_arrays(dataclasses.asdict(CFG), arrays, device="meta")
    assert idx.device == torch.device("meta") and idx.x.device.type == "cpu"
    assert idx.xnorm2.device.type == "cpu"
    ck = Checkpointer(tmp_path / "ckpt")
    save_segmented_index(ck, data)
    restored = load_segmented_index(ck, device="meta")
    plane = SegmentedIndex.from_arrays(dataclasses.asdict(CFG), {
        "segments": [dict(seg_id=0, **arrays)], "dead_rows": {0: np.zeros(len(x) - 192, bool)},
        "dead_version": 0, "delta_ids": np.zeros(0, np.int64),
        "delta_x": np.zeros((0, CFG.dim), np.float32), "delta_live": np.zeros(0, bool),
        "generation": 0, "next_seg_id": 1}, device="meta")
    for p in (restored, plane):
        assert p.device == torch.device("meta")
        for seg in p.segments:
            assert seg.index.device == p.device and seg.index.x.device.type == "cpu"
    srv = HarmonyServer(plane, n_nodes=2, device="meta")
    assert srv.device == srv.data.device == torch.device("meta")


def test_host_rows_give_the_device_gather_results():
    """``rerank_exact``, ``prewarm_tau`` and ``search_oracle`` gather the
    host rows and upload only those: their results are the ones a gather
    of a device copy of the rows gives, bit for bit (the oracle also with
    the corpus uploaded in several blocks)."""
    import repro_torch.core.search as t_search
    from repro_torch.core.index import assign_queries
    from repro_torch.core.pruning import prewarm_tau
    from repro_torch.core.search import rerank_exact, search_oracle

    x, data = _plane()
    idx = data.segments[0].index
    q = _queries(x)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, idx.nb, size=(len(q), 9))
    valid = torch.as_tensor(rng.random((len(q), 9)) > 0.2)
    qt = torch.as_tensor(q)
    sc, sel = rerank_exact(idx, qt, rows, valid, 5)
    xg, r = idx.x.clone(), torch.as_tensor(rows)
    d = ((qt * qt).sum(1)[:, None] - 2.0 * torch.einsum("md,mkd->mk", qt, xg[r])
         + (xg * xg).sum(1)[r])
    want_sc, want_sel = torch.sort(torch.where(valid, d, torch.inf), dim=1, stable=True)
    assert torch.equal(sc, want_sc[:, :5]) and torch.equal(sel, want_sel[:, :5])

    probes = assign_queries(idx, q)
    tau = prewarm_tau(idx, q, probes, 5)
    want = []
    for i in range(len(q)):
        rows_i = np.concatenate([np.arange(idx.offsets[c], idx.offsets[c] + min(
            idx.sizes[c], 4)) for c in dict.fromkeys(probes[i].tolist())])
        diff = idx.x[torch.as_tensor(rows_i)] - qt[i][None, :]
        s_i = torch.sort((diff * diff).sum(1)).values
        want.append(s_i[4].item() if len(s_i) >= 5 else np.inf)
    np.testing.assert_array_equal(tau, np.float32(want))

    whole = search_oracle(idx, q, k=5)
    small = t_search.ORACLE_ROWS
    try:
        t_search.ORACLE_ROWS = 64                    # 6 blocks of the 384 rows
        blocked = search_oracle(idx, q, k=5)
    finally:
        t_search.ORACLE_ROWS = small
    np.testing.assert_array_equal(whole.ids, blocked.ids)
    np.testing.assert_array_equal(whole.scores, blocked.scores)


@pytest.mark.cuda
def test_cuda_demotion_frees_the_report_device_bytes():
    """On the card, demoting a segment to the host tier lowers
    ``torch.cuda.memory_allocated`` by at least the bytes the memory report
    stops counting, and the served plane before any executor holds under
    5 % of its rows' bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    cfg = HarmonyConfig(dim=32, nlist=32, nprobe=8, topk=5, kmeans_iters=3)
    # a first build creates the libraries' workspaces, which are not the plane's
    SegmentedIndex.build(x[:256], cfg.replace(nlist=4), device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    data = SegmentedIndex.build(x, cfg, device="cuda")
    assert data.segments[0].index.x.device.type == "cpu"
    assert data.segments[0].index.x.is_pinned()
    assert torch.cuda.memory_allocated() - base < 0.05 * x.nbytes
    srv = HarmonyServer(data, n_nodes=2)
    srv.warmup_executors()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rep0 = data.memory_report()["device_bytes"]
    srv.prepare_placement({0: "host"})
    data.set_tiers({0: "host"})
    srv.adopt()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    assert freed >= rep0 - data.memory_report()["device_bytes"] > 0

