"""The port's ``HarmonyServer`` against the JAX package's on the same data
plane (carried across with ``SegmentedIndex.from_arrays``), on both
backends and in both precisions: a static index, after writes, after a
compaction (carried across, and each package's own at nprobe = nlist),
with int64 ids, across ``fail_node``/``join_node``/``refresh_plan``, with
equal ``ServeStats`` counters (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import SegmentedIndex as RSegmented
from repro.core.pruning import exact_scores
from repro.data import make_dataset
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import HarmonyServer as RServer
from repro_torch.core import SearchRequest, SegmentedIndex, TagIn
from repro_torch.kernels import ref as kref
from repro_torch.serve import ExecutorConfig, HarmonyServer
from repro_torch.serve import engine as t_engine
from test_executor import assert_matches_oracle
from test_torch_segments import apply_writes, port_plane, state_of

DIM = 16
R_EXEC = RExCfg(qb_buckets=(8,), chunk=64, use_pallas=False)
T_EXEC = ExecutorConfig(qb_buckets=(8,), chunk=64)
BOTH = [("host", "fp32"), ("spmd", "fp32"), ("host", "int8"), ("spmd", "int8")]


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=800, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = RCfg(dim=DIM, nlist=8, nprobe=3, topk=5, kmeans_iters=3)
    rng = np.random.default_rng(1)
    q = (ds.x[rng.choice(ds.nb, 20, replace=False)]
         + 0.05 * rng.standard_normal((20, DIM))).astype(np.float32)
    return ds, cfg, q


def pair(ref_plane, backend="spmd", precision="fp32", n_nodes=4, **kw):
    """The reference server on ``ref_plane`` and the port's on its copy."""
    r = RServer(ref_plane, n_nodes=n_nodes, backend=backend, executor_cfg=R_EXEC,
                precision=precision, **kw)
    t = HarmonyServer(port_plane(ref_plane), n_nodes=n_nodes, backend=backend,
                      executor_cfg=T_EXEC, precision=precision, device="cpu", **kw)
    return r, t


def brute_topk(data, q, k):
    ids, x = data.live_vectors()
    sc = exact_scores(x, q)
    order = np.argsort(sc, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(sc, order, axis=1), ids[order]


def same(t, r, q, **kw):
    rr, tr = r.search_batch(q, **kw), t.search_batch(q, **kw)
    assert tr.ids.dtype == np.int64 and tr.scores.dtype == np.float32
    assert_matches_oracle(tr, rr)
    return tr, rr


@pytest.mark.parametrize("backend,precision", BOTH)
def test_static_index_matches_reference(anns, backend, precision):
    ds, cfg, q = anns
    r, t = pair(RSegmented.build(ds.x, cfg), backend, precision)
    tr, rr = same(t, r, q)
    same(t, r, q[:3], k=8)
    assert tr.stats.get("precision", "fp32") == rr.stats.get("precision", "fp32")
    if backend == "spmd":
        assert tr.stats["splits"] == rr.stats["splits"] == 3     # 20 > qb 8
    assert t.stats.spmd_batches == r.stats.spmd_batches
    assert (t.plan.v_shards, t.plan.d_blocks) == (r.plan.v_shards, r.plan.d_blocks)


@pytest.mark.parametrize("backend,precision", BOTH)
def test_after_writes_matches_reference(anns, backend, precision):
    ds, cfg, q = anns
    r, t = pair(RSegmented.build(ds.x, cfg), backend, precision)
    for burst in range(2):
        rd = apply_writes(r, np.random.default_rng(burst), ds.nb, id_base=10_000 + 100 * burst)
        td = apply_writes(t, np.random.default_rng(burst), ds.nb, id_base=10_000 + 100 * burst)
        assert rd == td
        tr, rr = same(t, r, q)
        assert tr.stats["segments"] == 1 and tr.stats["delta_candidates"] == \
            rr.stats["delta_candidates"]
    assert all(t.data.has(i) for i in tr.ids[tr.ids >= 0].tolist())   # no deleted id
    assert (t.stats.upserts, t.stats.deletes) == (r.stats.upserts, r.stats.deletes)


@pytest.mark.parametrize("backend,precision", BOTH)
def test_compacted_plane_carried_across(anns, backend, precision):
    """After a delta seal and more writes (three parts per batch), the
    reference's plane carried across serves as the reference does at
    nprobe < nlist."""
    ds, cfg, q = anns
    ref = RSegmented.build(ds.x, cfg)
    apply_writes(ref, np.random.default_rng(5), ds.nb)
    ref.compact_inline()
    apply_writes(ref, np.random.default_rng(6), ds.nb, id_base=30_000)
    r, t = pair(ref, backend, precision)
    assert t.data.n_segments == 2 and t.data.delta_len > 0
    tr, rr = same(t, r, q)
    assert tr.stats["segments"] == 2 and tr.stats["generation"] == 1


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_own_compaction_at_full_probe(anns, backend):
    """Each package seals with its own k-means; at nprobe = nlist both
    equal brute force over the live set, through a generation swap."""
    ds, cfg, q = anns
    cfg = cfg.replace(nprobe=cfg.nlist)
    r, t = pair(RSegmented.build(ds.x, cfg), backend)
    for srv in (r, t):
        apply_writes(srv, np.random.default_rng(7), ds.nb)
    same(t, r, q)
    for srv in (r, t):
        srv.data.compact_inline()
        apply_writes(srv, np.random.default_rng(8), ds.nb, id_base=20_000)
    tr, rr = same(t, r, q)
    bs, bi = brute_topk(t.data, q, cfg.topk)
    np.testing.assert_allclose(tr.scores, bs, rtol=1e-3, atol=1e-3)
    for srv in (r, t):
        srv.data.compact_inline(merge_all=True)
        srv.adopt()
    tr, rr = same(t, r, q)
    assert t.generation == r.generation == 2
    assert t.stats.generation_swaps == r.stats.generation_swaps


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_int64_ids(anns, backend):
    """An id beyond int32 comes back on both backends: on spmd through the
    fused merge (which carries columns, not ids) and, once sealed, through
    the segment's executor (which carries packed rows); on host through
    the host engine and the host merge."""
    ds, cfg, q = anns
    r, t = pair(RSegmented.build(ds.x, cfg), backend)
    big = 3_000_000_000
    vec = (ds.x[:1] + 2.0).astype(np.float32)
    calls = []
    real = t_engine.merge_topk

    def spy(parts, k, fused=False, device=None):
        calls.append(fused)
        return real(parts, k, fused=fused, device=device)

    t_engine.merge_topk = spy
    try:
        for srv in (r, t):
            srv.upsert([big], vec)
        tr, rr = same(t, r, vec)
        assert int(tr.ids[0, 0]) == big and tr.scores[0, 0] == pytest.approx(0, abs=1e-5)
        assert calls == [backend == "spmd"]        # the backend decides, not the ids
        for srv in (r, t):
            srv.data.compact_inline()
        kref.running_topk_ref.calls = 0
        tr, rr = same(t, r, np.concatenate([vec, q[:4]]))
        assert int(tr.ids[0, 0]) == big
        st = t._seg_states
        assert big in st[max(st)].segment.index.ids
        spmd = backend == "spmd"
        assert [bool(st[s].executors) for s in sorted(st)] == [spmd, spmd]
        assert [st[s].corpus is not None for s in sorted(st)] == [not spmd, not spmd]
        assert (kref.running_topk_ref.calls > 0) == spmd
    finally:
        t_engine.merge_topk = real


def test_spmd_merge_is_fused_in_part_order(anns):
    """On the spmd backend the parts (sealed segments in snapshot order,
    then the delta) go through one fused merge; a lone segment is not
    merged at all."""
    ds, cfg, q = anns
    ref = RSegmented.build(ds.x, cfg)
    apply_writes(ref, np.random.default_rng(2), ds.nb)
    ref.compact_inline()
    apply_writes(ref, np.random.default_rng(3), ds.nb, id_base=50_000)
    _, t = pair(ref)
    seen = []
    real = t_engine.merge_topk

    def spy(parts, k, fused=False, device=None):
        seen.append((len(parts), fused, [p[1].copy() for p in parts]))
        return real(parts, k, fused=fused, device=device)

    t_engine.merge_topk = spy
    try:
        res = t.search_batch(q)
        res_host = t.search_batch(q, backend="host")
    finally:
        t_engine.merge_topk = real
    assert [(n, f) for n, f, _ in seen] == [(3, True), (3, False)]
    assert_matches_oracle(res, res_host)
    delta_ids = set(t.data.snapshot().delta_ids.tolist())
    assert set(seen[0][2][2][seen[0][2][2] >= 0].tolist()) <= delta_ids
    _, lone = pair(RSegmented.build(ds.x, cfg))
    seen.clear()
    t_engine.merge_topk = spy
    try:
        lone.search_batch(q)
    finally:
        t_engine.merge_topk = real
    assert seen == []


def test_elastic_replan_and_counters(anns):
    ds, cfg, q = anns
    r, t = pair(RSegmented.build(ds.x, cfg), "host", n_nodes=4, replan_every=2)
    same(t, r, q)
    same(t, r, q)                                  # replan_every=2 re-plans here
    for srv in (r, t):
        srv.fail_node(1)
    assert (t.plan.v_shards, t.plan.d_blocks) == (r.plan.v_shards, r.plan.d_blocks)
    np.testing.assert_array_equal(t.plan.cluster_to_shard, r.plan.cluster_to_shard)
    same(t, r, q)
    for srv in (r, t):
        srv.join_node()
        srv.refresh_plan()
    np.testing.assert_array_equal(t.plan.cluster_to_shard, r.plan.cluster_to_shard)
    np.testing.assert_array_equal(t.corpus.ids_shard, r.corpus.ids_shard)
    same(t, r, q, backend="spmd")
    apply_writes(r, np.random.default_rng(9), ds.nb)
    apply_writes(t, np.random.default_rng(9), ds.nb)
    same(t, r, q)
    assert t.stats.summary() == r.stats.summary()
    assert t.stats.batches == 5 and t.stats.replans == r.stats.replans == 5
    assert len(t.stats.latencies_ms) == 5 and t.stats.qps > 0
    with pytest.raises(RuntimeError, match="no live nodes"):
        for n in range(t.cluster.n_nodes):
            t.fail_node(n)


def test_precision_override_and_requests(anns, monkeypatch):
    """A per-batch precision override on spmd is served by the segment's
    executor of that precision, built on first use (the reference serves
    it on its host path); the host engine is never reached. Requests,
    filters and hybrid text equal the reference's."""
    ds, cfg, q = anns
    r, t = pair(RSegmented.build(ds.x, cfg), "spmd", "fp32")

    def no_host(*a, **kw):
        raise AssertionError("the spmd backend reached the host engine")

    monkeypatch.setattr(t_engine, "harmony_search", no_host)
    monkeypatch.setattr(t_engine, "two_stage_search", no_host)
    same(t, r, q, precision="int8")
    ex = t._seg_states[0].executors
    assert sorted(ex) == ["int8"] and ex["int8"].precision == "int8"
    assert ex["int8"].cfg.rerank_factor == t.cfg.rerank_factor
    int8_ex = ex["int8"]
    same(t, r, q, precision="int8")
    same(t, r, q)
    assert sorted(ex) == ["fp32", "int8"] and ex["int8"] is int8_ex   # cached
    r8, t8 = pair(RSegmented.build(ds.x, cfg), "spmd", "int8")
    same(t8, r8, q, precision="fp32")
    assert sorted(t8._seg_states[0].executors) == ["fp32"]
    assert t8._seg_states[0].executors["fp32"].precision == "fp32"
    monkeypatch.undo()
    same(t, r, q[:4], k=7, backend="host")
    rq = SearchRequest(vector=q[0], k=3, precision="int8")
    from repro.core import SearchRequest as RRequest
    got = t.search_batch(rq)
    want = r.search_batch(RRequest(vector=q[0], k=3, precision="int8"))
    assert_matches_oracle(got, want)
    # a filter, hybrid text and a request's filter are served, as the
    # reference serves them (rows with metadata in the delta; the sealed
    # segment has none, so the filter excludes all of it)
    meta = {"color": np.arange(16) % 2,
            "text": [f"doc {'red' if i % 3 else 'blue'} {i}" for i in range(16)]}
    for srv in (r, t):
        srv.upsert(np.arange(9000, 9016), q[:16] + 0.01, meta=meta)
    flt = TagIn("color", (1,))
    same(t, r, q, flt=flt)
    for kw in (dict(hybrid_text="red doc"), dict(flt=flt, hybrid_text="blue")):
        tr, rr = same(t, r, q, **kw)
        assert tr.stats["fused"] and rr.stats["fused"]
        np.testing.assert_array_equal(tr.ids, rr.ids)
    from repro.core import TagIn as RTagIn
    got = t.search_batch(SearchRequest(vector=q[0], filter=flt))
    want = r.search_batch(RRequest(vector=q[0], filter=RTagIn("color", (1,))))
    assert_matches_oracle(got, want)
    assert set(got.ids[got.ids >= 0].tolist()) <= set(range(9001, 9016, 2))
    with pytest.raises(ValueError):
        HarmonyServer(t.data, n_nodes=2, backend="tpu", device="cpu")


def test_stale_snapshot_never_rolls_back(anns):
    """Generations move forward only: a snapshot older than the adopted
    one is refused, as in the reference; staged state is promoted on the
    swap."""
    ds, cfg, q = anns
    r, t = pair(RSegmented.build(ds.x, cfg), "spmd")
    for srv in (r, t):
        apply_writes(srv, np.random.default_rng(4), ds.nb)
        old = srv.data.snapshot()
        plan = srv.data.begin_compaction()
        segs = srv.data.seal(plan)
        srv.prepare_segments(segs)
        staged = srv._staged[segs[0].seg_id]
        srv.data.commit_compaction(plan, segs)
        srv.adopt()
        assert srv._seg_states[segs[0].seg_id] is staged
        assert srv.generation == 1
        assert srv._sync(old) is False
        assert srv.generation == 1 and segs[0].seg_id in srv._seg_states
        assert srv.data.set_tiers({0: "device"}) == 1
        srv.adopt()
        assert srv.stats.placement_swaps == 1
    same(t, r, q)
    assert t.executor is t._seg_states[0].executors["fp32"]
    assert t.stats.generation_swaps == r.stats.generation_swaps == 1


@pytest.mark.cuda
def test_cuda_server_matches_cpu(anns):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ds, cfg, q = anns
    ref = RSegmented.build(ds.x, cfg)
    apply_writes(ref, np.random.default_rng(5), ds.nb)
    ref.compact_inline()
    apply_writes(ref, np.random.default_rng(6), ds.nb, id_base=30_000)
    cpu = HarmonyServer(port_plane(ref), n_nodes=4, backend="spmd", device="cpu")
    gpu = HarmonyServer(
        SegmentedIndex.from_arrays(dataclasses.asdict(ref.cfg), state_of(ref),
                                   device="cuda"),
        n_nodes=4, backend="spmd", device="cuda")
    for precision in ("fp32", "int8"):
        assert_matches_oracle(gpu.search_batch(q, precision=precision),
                              cpu.search_batch(q, precision=precision))


def test_entry_points_need_cuda_by_default(monkeypatch, anns):
    """``device=None`` means CUDA for the data plane, the server, the delta
    scan and the fused merge; without CUDA they raise."""
    from repro_torch.config import HarmonyConfig
    from repro_torch.core import delta_topk, merge_topk

    ds, cfg, q = anns
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = HarmonyConfig(**dataclasses.asdict(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentedIndex(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentedIndex.build(ds.x, tcfg)
    plane = SegmentedIndex.build(ds.x, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        HarmonyServer(plane, n_nodes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        delta_topk(ds.x[:4], np.arange(4), np.ones(4, bool), q, 3)
    parts = [(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64))]
    with pytest.raises(RuntimeError, match="CUDA"):
        merge_topk(parts, 3, fused=True)
    merge_topk(parts, 3)                            # the host merge needs no device
    srv = HarmonyServer(plane, n_nodes=2, device="cpu")
    assert srv.device.type == "cpu"
    assert srv.backend == "spmd"                    # the card's path by default
    assert all(st.corpus is None for st in srv._seg_states.values())
