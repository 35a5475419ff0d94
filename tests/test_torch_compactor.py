"""The port's compactor on the mutable segmented data plane (CPU).

Mirrors of ``tests/test_mutable_index.py``'s compaction, lifecycle,
checkpoint and bookkeeping cases through ``repro_torch`` (the scheduler
and fleet cases come with the serving plane). The port's k-means is
seeded from numpy, so a compacted plane has other centres than the
reference's: compacted planes are held against the brute force at
nprobe = nlist, or against the port's own ``build_ivf`` over the live
set. The two compactors' events (reasons, generations, segment counts)
are equal on the same writes, and a merge-all frees the retired
segments' executors at the adopt.
"""

import gc
import time
import weakref

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import SegmentedIndex as RSegmented
from repro.data import make_dataset
from repro.serve import CompactionConfig as RCompactionConfig
from repro.serve import Compactor as RCompactor
from repro.serve import HarmonyServer as RServer
from repro_torch.checkpoint import Checkpointer, load_segmented_index, save_segmented_index
from repro_torch.config import HarmonyConfig
from repro_torch.core import SegmentedIndex, build_ivf
from repro_torch.core.index import prewarm_table_bytes
from repro_torch.serve import CompactionConfig, Compactor, ExecutorConfig, HarmonyServer
from test_torch_engine import brute_topk
from test_torch_segments import port_plane

DIM = 16
TINY_EXEC = ExecutorConfig(qb_buckets=(8,), chunk=64)


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=600, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = HarmonyConfig(dim=DIM, nlist=8, nprobe=8, topk=5, kmeans_iters=3)
    return ds, cfg


def apply_writes(target, rng, nb, n_upsert=40, n_delete=25, id_base=10_000):
    """Fresh inserts, overwrites of existing ids, and deletes (some of the
    fresh ids), as ``tests/test_mutable_index.py`` writes them."""
    new_ids = np.arange(id_base, id_base + n_upsert)
    target.upsert(new_ids, rng.standard_normal((n_upsert, DIM)).astype(np.float32))
    overwrite = rng.choice(nb, size=n_upsert // 2, replace=False)
    target.upsert(overwrite, rng.standard_normal((len(overwrite), DIM)).astype(np.float32))
    dele = np.concatenate([rng.choice(nb, size=n_delete, replace=False), new_ids[:5]])
    target.delete(dele)
    return new_ids, dele


def _server(data, backend="spmd", n_nodes=2):
    return HarmonyServer(data, n_nodes=n_nodes, backend=backend, executor_cfg=TINY_EXEC,
                         device="cpu")


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_upsert_delete_compact_matches_fresh_build(anns, backend):
    """Writes and compaction, then segmented search equals the port's own
    ``build_ivf`` over the live set, on both backends."""
    ds, cfg = anns
    rng = np.random.default_rng(42)
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = _server(data, backend, n_nodes=4)
    q = (ds.x[:12] + 0.05 * rng.standard_normal((12, DIM))).astype(np.float32)
    new_ids, dele = apply_writes(srv, rng, ds.nb)
    res = srv.search_batch(q, k=5)
    bs, _ = brute_topk(data, q, 5)
    np.testing.assert_allclose(res.scores, bs, rtol=1e-3, atol=1e-3)
    assert not np.isin(res.ids, dele).any()

    comp = Compactor(data, srv, CompactionConfig(delta_threshold=1), device="cpu")
    ev = comp.maybe_compact()
    assert ev is not None and data.generation >= 1
    comp.run_once(merge_all=True, reason="test")
    assert data.n_segments == 1 and data.delta_len == 0
    assert srv.generation == data.generation

    live_ids, live_x = data.live_vectors()
    fresh = _server(build_ivf(live_x, cfg, device="cpu"), backend, n_nodes=4)
    res = srv.search_batch(q, k=5)
    want = fresh.search_batch(q, k=5)
    np.testing.assert_allclose(res.scores, want.scores, rtol=1e-3, atol=1e-3)
    mapped = np.where(want.ids >= 0, live_ids[want.ids], -1)
    same = (mapped == res.ids) | ~np.isfinite(res.scores)
    assert same.mean() > 0.9          # equal but for float tie order
    bs, _ = brute_topk(data, q, 5)
    np.testing.assert_allclose(res.scores, bs, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_deleted_never_resurface_upserted_reachable(anns, backend):
    ds, cfg = anns
    rng = np.random.default_rng(7)
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = _server(data, backend)
    new_vec = rng.standard_normal((1, DIM)).astype(np.float32)
    srv.upsert([9999], new_vec)
    srv.delete([0, 1, 2])
    comp = Compactor(data, srv, CompactionConfig(), device="cpu")
    for stage in ("delta", "sealed", "merged"):
        res = srv.search_batch(np.concatenate([new_vec, ds.x[:3]]), k=5)
        assert int(res.ids[0, 0]) == 9999
        assert res.scores[0, 0] == pytest.approx(0.0, abs=1e-5)
        assert not np.isin(res.ids, [0, 1, 2]).any()
        if stage == "delta":
            comp.run_once(reason="seal")
        elif stage == "sealed":
            comp.run_once(merge_all=True, reason="merge")
    assert data.n_segments == 1 and not data.has(0) and data.has(9999)


def test_upsert_overwrites_old_version(anns):
    """The newest version wins at once: the sealed copy of an overwritten
    id is never returned."""
    ds, cfg = anns
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = _server(data)
    old_vec = ds.x[5:6]
    new_vec = (old_vec + 3.0).astype(np.float32)
    srv.upsert([5], new_vec)
    res = srv.search_batch(np.concatenate([old_vec, new_vec]), k=3)
    hit = res.ids[0] == 5
    if hit.any():
        d_new = float(np.sum((old_vec - new_vec) ** 2))
        assert res.scores[0][hit][0] == pytest.approx(d_new, rel=1e-3)
    assert int(res.ids[1, 0]) == 5
    assert res.scores[1, 0] == pytest.approx(0.0, abs=1e-5)


def test_background_compactor_thread_live_writes(anns):
    """The background thread seals and merges while writes stream in and
    batches are served; the final state is exact. The thread is joined
    within the test's own limit."""
    ds, cfg = anns
    rng = np.random.default_rng(11)
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = _server(data)
    q = ds.x[:8]
    comp = Compactor(data, srv, CompactionConfig(delta_threshold=16, poll_s=0.005),
                     device="cpu")
    t_end = time.monotonic() + 60.0                 # this test's limit
    comp.start()
    try:
        for i in range(12):
            srv.upsert(np.arange(20_000 + 8 * i, 20_000 + 8 * (i + 1)),
                       rng.standard_normal((8, DIM)).astype(np.float32))
            srv.delete([int(rng.integers(0, 600))])
            srv.search_batch(q, k=5)
            assert time.monotonic() < t_end, "the serving loop outlived 60 s"
        while not comp.events and time.monotonic() < t_end:
            comp._stop.wait(0.01)
    finally:
        assert comp.stop(timeout=20.0), "the compactor thread outlived 20 s"
    assert not comp.errors
    assert data.generation >= 1 and comp.events
    res = srv.search_batch(q, k=5)
    bs, _ = brute_topk(data, q, 5)
    np.testing.assert_allclose(res.scores, bs, rtol=1e-3, atol=1e-3)


def test_checkpoint_roundtrip_search_identical(anns, tmp_path):
    ds, cfg = anns
    rng = np.random.default_rng(9)
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    apply_writes(data, rng, ds.nb)
    data.compact_inline()                       # seal: 2 segments, gen 1
    data.delete([40])                           # a tombstone after the seal
    data.upsert([31_000], rng.standard_normal((1, DIM)).astype(np.float32))
    ck = Checkpointer(str(tmp_path / "ckpt"))
    save_segmented_index(ck, data)
    assert ck.latest_step() == data.generation
    back = load_segmented_index(ck, device="cpu")
    assert (back.generation, back.n_segments, back.nb_live) == (
        data.generation, data.n_segments, data.nb_live)
    q = ds.x[:10]
    res_a = _server(data, n_nodes=4).search_batch(q, k=5)
    res_b = _server(back, n_nodes=4).search_batch(q, k=5)
    np.testing.assert_array_equal(res_a.ids, res_b.ids)
    np.testing.assert_allclose(res_a.scores, res_b.scores)
    back.delete([41])
    back.compact_inline(merge_all=True)
    assert back.n_segments == 1 and not back.has(41)


def test_tombstone_aware_sizes_and_memory(anns):
    """``live_sizes``, ``memory_bytes`` and the dead counts, equal to the
    reference's on the same plane and writes."""
    ds, cfg = anns
    ref = RSegmented.build(ds.x, RCfg(**cfg.__dict__))
    data = port_plane(ref)
    seg, rseg = data.segments[0], ref.segments[0]
    assert data.live_sizes(seg).sum() == ds.x.shape[0]
    # the port's card also holds the τ prewarm's sample table (fp32, pruning)
    table = prewarm_table_bytes(seg.index)
    mem0 = data.memory_bytes()
    assert mem0 == ref.memory_bytes() + table > ref.memory_bytes()
    for plane in (data, ref):
        plane.delete(np.arange(50))
    assert data.live_sizes(seg).sum() == ds.x.shape[0] - 50
    np.testing.assert_array_equal(data.live_sizes(seg), ref.live_sizes(rseg))
    assert data.nb_live == ds.x.shape[0] - 50
    for plane in (data, ref):
        plane.upsert([99_999], np.zeros((1, DIM), np.float32))
    assert data.memory_bytes() > mem0           # the delta buffer counts
    assert data.memory_bytes() == ref.memory_bytes() + table
    assert data.delta_len == 1
    assert data.dead_count_by_segment()[seg.seg_id] == 50


def test_compaction_journal_replays_concurrent_writes(anns):
    """Writes that land between begin and commit survive the swap."""
    ds, cfg = anns
    rng = np.random.default_rng(13)
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    data.upsert([50_000], rng.standard_normal((1, DIM)).astype(np.float32))
    plan = data.begin_compaction(merge_all=True)
    data.delete([0, 50_000])
    v = rng.standard_normal((1, DIM)).astype(np.float32)
    data.upsert([50_001], v)
    data.upsert([1], v + 1.0)                   # overwrite an id in the plan
    segs = data.seal(plan)
    data.commit_compaction(plan, segs)
    assert not data.has(0) and not data.has(50_000)
    assert data.has(50_001) and data.has(1)
    res = _server(data).search_batch(np.concatenate([v, v + 1.0]), k=1)
    assert res.ids[:, 0].tolist() == [50_001, 1]
    assert np.allclose(res.scores[:, 0], 0.0, atol=1e-5)


def test_stale_snapshot_never_rolls_back_generation(anns):
    """A thread carrying a pre-swap snapshot must not roll the server back
    a generation; ``_sync`` refuses and serving goes on."""
    ds, cfg = anns
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = _server(data)
    stale = data.snapshot()
    data.upsert([77_000], np.ones((1, DIM), np.float32))
    data.compact_inline()
    srv.adopt()
    gen = srv.generation
    assert gen == data.generation == 1
    assert srv._sync(stale) is False
    assert srv.generation == gen
    res = srv.search_batch(ds.x[:4], k=5)
    bs, _ = brute_topk(data, ds.x[:4], 5)
    np.testing.assert_allclose(res.scores, bs, rtol=1e-3, atol=1e-3)


def test_compactor_events_match_reference(anns):
    """The same writes and policy drive both compactors through the same
    cycles: equal reasons, generations, row and segment counts, and equal
    live sets after each cycle."""
    ds, cfg = anns
    rcfg = RCfg(**cfg.__dict__)
    ref = RSegmented.build(ds.x, rcfg)
    data = port_plane(ref)
    rsrv = RServer(ref, n_nodes=2)
    srv = _server(data)
    policy = dict(delta_threshold=30, max_segments=2, max_dead_fraction=0.25)
    rcomp = RCompactor(ref, rsrv, RCompactionConfig(**policy))
    comp = Compactor(data, srv, CompactionConfig(**policy), device="cpu")
    keys = ("reason", "generation", "merge_all", "sealed_rows", "merged_segments",
            "carried_segments", "new_segments", "segments_after", "placed")
    rng = np.random.default_rng(17)
    for step in range(5):
        ids = np.arange(40_000 + 40 * step, 40_000 + 40 * (step + 1))
        vecs = rng.standard_normal((40, DIM)).astype(np.float32)
        dele = rng.choice(ds.nb, size=60, replace=False)
        for s_, c_ in ((srv, comp), (rsrv, rcomp)):
            s_.upsert(ids, vecs)
            s_.delete(dele)
        ev, rev = comp.maybe_compact(), rcomp.maybe_compact()
        assert (ev is None) == (rev is None), step
        if ev is not None:
            assert {k: ev[k] for k in keys} == {k: rev[k] for k in keys}, step
        np.testing.assert_array_equal(data.live_vectors()[0], ref.live_vectors()[0])
        assert (data.n_segments, data.generation, data.delta_len) == (
            ref.n_segments, ref.generation, ref.delta_len)
    assert {e["reason"] for e in comp.events} >= {"delta_full", "too_many_segments"}
    comp.recover()
    assert comp.events[-1]["reason"] == "recover"
    q = ds.x[:6]
    bs, _ = brute_topk(data, q, 5)
    np.testing.assert_allclose(srv.search_batch(q, k=5).scores, bs, rtol=1e-3, atol=1e-3)


def test_merge_all_frees_the_retired_executors(anns):
    """After a merge-all and the adopt, nothing holds the old segments'
    executors: they (and on the card their memory) go at once, without a
    garbage collection."""
    ds, cfg = anns
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = _server(data)
    srv.upsert(np.arange(70_000, 70_040), ds.x[:40] + 0.1)
    comp = Compactor(data, srv, CompactionConfig(), device="cpu")
    comp.run_once(reason="seal")
    srv.search_batch(ds.x[:8], k=5)
    old = [weakref.ref(ex) for st in srv._seg_states.values()
           for ex in st.executors.values()]
    old_idx = [weakref.ref(s.index) for s in data.segments]
    assert len(old) == 2
    gc.disable()
    try:
        comp.run_once(merge_all=True, reason="merge")
        assert all(r() is None for r in old), "a retired executor is still held"
        assert all(r() is None for r in old_idx), "a retired segment is still held"
    finally:
        gc.enable()
    assert data.n_segments == 1 and len(srv._seg_states) == 1


def test_compactor_device_follows_the_plane(anns):
    """The compactor works on the plane's device: CUDA by default, which
    a CPU plane refuses."""
    ds, cfg = anns
    data = SegmentedIndex.build(ds.x[:64], cfg.replace(nlist=4, nprobe=4), device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        Compactor(data)
    assert Compactor(data, device="cpu").device.type == "cpu"
