"""The port's mutable segmented data plane against the JAX package: the
same write sequence on both planes gives equal snapshots and live sets;
the compaction journal, point-in-time snapshots, per-row metadata and
``SegmentedIndex.from_arrays`` carrying a reference plane across (CPU)."""

import dataclasses

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import SegmentedIndex as RSegmented
from repro.core import build_ivf as r_build
from repro.core import search_oracle as r_oracle
from repro.core.index import meta_rows_from_batch as r_meta_rows
from repro.core.index import meta_rows_to_store as r_meta_store
from repro.data import make_dataset
from repro_torch.config import HarmonyConfig
from repro_torch.core import SegmentedIndex, build_ivf, ivf_from_arrays, search_oracle
from repro_torch.core.index import TAG_MISSING, meta_rows_from_batch, meta_rows_to_store
from test_executor import assert_matches_oracle

DIM = 16


def ivf_arrays(index):
    """The :func:`ivf_from_arrays` arrays of a reference index, meta as a
    plain dict of columns."""
    m = index.meta
    return dict(centers=index.centers, x=index.x, ids=index.ids,
                cluster_of=index.cluster_of, offsets=index.offsets,
                meta=None if m is None else dict(tags=m.tags, nums=m.nums,
                                                 texts=m.texts))


def state_of(plane):
    """A reference ``SegmentedIndex`` as the plain numpy state that
    ``SegmentedIndex.from_arrays`` takes."""
    snap = plane.snapshot()
    return dict(
        segments=[dict(seg_id=s.seg_id, **ivf_arrays(s.index)) for s in snap.segments],
        dead_rows=snap.dead_rows, dead_version=snap.dead_version,
        delta_ids=snap.delta_ids, delta_x=snap.delta_x,
        delta_live=snap.delta_live, delta_meta=snap.delta_meta,
        generation=snap.generation, next_seg_id=plane._next_seg_id,
        op_count=plane.op_count,
    )


def port_plane(ref_plane):
    return SegmentedIndex.from_arrays(dataclasses.asdict(ref_plane.cfg),
                                      state_of(ref_plane), device="cpu")


def assert_same_plane(t, r, sealed=True):
    """Equal snapshots (dead bitmaps, dead_version, delta ids/rows/live/
    meta, op_count) and equal live sets."""
    ts, rs = t.snapshot(), r.snapshot()
    assert ts.generation == rs.generation
    assert t.op_count == r.op_count
    assert [s.seg_id for s in ts.segments] == [s.seg_id for s in rs.segments]
    np.testing.assert_array_equal(ts.delta_ids, rs.delta_ids)
    np.testing.assert_array_equal(ts.delta_x, rs.delta_x)
    np.testing.assert_array_equal(ts.delta_live, rs.delta_live)
    assert ts.delta_meta == rs.delta_meta
    if sealed:
        assert ts.dead_version == rs.dead_version
        assert ts.dead_rows.keys() == rs.dead_rows.keys()
        for sid in rs.dead_rows:
            np.testing.assert_array_equal(ts.dead_rows[sid], rs.dead_rows[sid])
    ti, tx = t.live_vectors()
    ri, rx = r.live_vectors()
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tx, rx)
    assert (t.nb_live, t.delta_len, t.n_segments) == (r.nb_live, r.delta_len, r.n_segments)
    assert t.dead_count_by_segment() == r.dead_count_by_segment()


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=600, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = RCfg(dim=DIM, nlist=8, nprobe=3, topk=5, kmeans_iters=3)
    return ds, cfg


def planes(anns):
    ds, cfg = anns
    ref = RSegmented.build(ds.x, cfg)
    return ref, port_plane(ref)


def apply_writes(target, rng, nb, n_upsert=40, n_delete=25, id_base=10_000):
    """``tests/test_mutable_index.py``'s burst: fresh inserts (with
    metadata), overwrites of existing ids, and deletes, some of freshly
    written ids."""
    new_ids = np.arange(id_base, id_base + n_upsert)
    target.upsert(new_ids, rng.standard_normal((n_upsert, DIM)).astype(np.float32),
                  meta={"color": np.arange(n_upsert) % 3,
                        "price": np.linspace(1, 9, n_upsert)})
    overwrite = rng.choice(nb, size=n_upsert // 2, replace=False)
    target.upsert(overwrite,
                  rng.standard_normal((len(overwrite), DIM)).astype(np.float32))
    dele = np.concatenate([rng.choice(nb, size=n_delete, replace=False), new_ids[:5]])
    return target.delete(dele)


def test_from_arrays_round_trip_of_a_static_plane(anns):
    ref, port = planes(anns)
    assert_same_plane(port, ref)
    assert port.device.type == "cpu" and port.segments[0].index.x.device.type == "cpu"
    assert port.nlist == ref.nlist and port.dim == ref.dim


@pytest.mark.parametrize("seed", [0, 1])
def test_same_writes_give_equal_snapshots(anns, seed):
    ref, port = planes(anns)
    nb = anns[0].nb
    for burst in range(3):
        rr = apply_writes(ref, np.random.default_rng(seed * 10 + burst), nb,
                          id_base=10_000 + 100 * burst)
        tr = apply_writes(port, np.random.default_rng(seed * 10 + burst), nb,
                          id_base=10_000 + 100 * burst)
        assert tr == rr
        assert_same_plane(port, ref)
    for i in (0, 10_000, 10_005, 10_205, 99):
        assert port.has(i) == ref.has(i)
    assert port.delete([123_456]) == ref.delete([123_456]) == 0
    assert_same_plane(port, ref)


def test_snapshots_are_point_in_time(anns):
    _, port = planes(anns)
    port.upsert([5000, 5001], np.ones((2, DIM), np.float32), meta=[{"a": 1}, None])
    snap = port.snapshot()
    dead0 = snap.dead_rows[0].copy()
    x0 = snap.delta_x.copy()
    # an upsert of a sealed id, a delete of a delta id, and enough appends
    # to grow the delta buffer
    port.upsert([7], np.zeros((1, DIM), np.float32))
    port.delete([5000])
    port.upsert(np.arange(6000, 6100), np.full((100, DIM), 3.0, np.float32))
    np.testing.assert_array_equal(snap.dead_rows[0], dead0)
    np.testing.assert_array_equal(snap.delta_x, x0)
    assert snap.delta_live.tolist() == [True, True]
    assert snap.delta_meta == ({"a": 1}, None)
    assert snap.delta_count == 2
    now = port.snapshot()
    assert now.delta_count == 102 and now.dead_rows[0].sum() == 1
    assert now.dead_version == snap.dead_version + 1


@pytest.mark.parametrize("merge_all", [False, True])
def test_journal_replay_across_a_compaction(anns, merge_all):
    """begin → writes during the seal → seal → commit on both planes: the
    journal replays onto the new segment set, so the live set, the delta
    and the carried tombstones agree (the new segment's packing follows
    each package's own k-means)."""
    ref, port = planes(anns)
    nb = anns[0].nb
    for plane in (ref, port):
        apply_writes(plane, np.random.default_rng(3), nb)
    rplan = ref.begin_compaction(merge_all=merge_all)
    tplan = port.begin_compaction(merge_all=merge_all)
    np.testing.assert_array_equal(tplan.ids, rplan.ids)
    np.testing.assert_array_equal(tplan.x, rplan.x)
    assert tplan.meta == rplan.meta
    assert (tplan.merge_seg_ids, tplan.carry_seg_ids) == (rplan.merge_seg_ids,
                                                          rplan.carry_seg_ids)
    assert port.compaction_in_flight and ref.compaction_in_flight
    with pytest.raises(RuntimeError, match="in flight"):
        port.begin_compaction()
    for plane in (ref, port):                      # writes during the seal
        apply_writes(plane, np.random.default_rng(4), nb, n_upsert=10,
                     n_delete=6, id_base=20_000)
        plane.delete([10_020, 10_021])
    rsegs, tsegs = ref.seal(rplan), port.seal(tplan)
    assert [s.seg_id for s in tsegs] == [s.seg_id for s in rsegs]
    assert tsegs[0].index.meta is not None
    assert ref.commit_compaction(rplan, rsegs) == port.commit_compaction(tplan, tsegs)
    assert not port.compaction_in_flight
    assert_same_plane(port, ref, sealed=False)
    ts, rs = port.snapshot(), ref.snapshot()
    assert ts.dead_version == rs.dead_version
    for sid in rs.dead_rows:
        assert ts.dead_rows[sid].sum() == rs.dead_rows[sid].sum()
        if sid in rplan.carry_seg_ids:
            np.testing.assert_array_equal(ts.dead_rows[sid], rs.dead_rows[sid])
    with pytest.raises(RuntimeError, match="no compaction"):
        port.commit_compaction(tplan, tsegs)


def test_compacted_plane_carried_across(anns):
    """A reference plane after a delta seal, a full merge and more writes,
    carried across with ``from_arrays``: equal snapshots, and each sealed
    segment searches as the reference's at nprobe < nlist."""
    ds, cfg = anns
    ref = RSegmented.build(ds.x, cfg)
    apply_writes(ref, np.random.default_rng(5), ds.nb)
    ref.compact_inline()
    apply_writes(ref, np.random.default_rng(6), ds.nb, id_base=30_000)
    port = port_plane(ref)
    assert port.n_segments == 2 and port.generation == 1
    assert_same_plane(port, ref)
    q = (ds.x[:20] + 0.05).astype(np.float32)
    for ts, rs in zip(port.snapshot().segments, ref.snapshot().segments):
        dead = ref.snapshot().dead_rows[rs.seg_id]
        assert ts.index.cfg.nlist == rs.index.cfg.nlist
        assert ts.index.cfg.nprobe < ts.index.nlist or ts.index.nlist == 1
        assert_matches_oracle(search_oracle(ts.index, q, dead_rows=dead),
                              r_oracle(rs.index, q, dead_rows=dead))
    # both go on taking the same writes
    for plane in (ref, port):
        apply_writes(plane, np.random.default_rng(7), ds.nb, id_base=40_000)
        plane.compact_inline(merge_all=True)
    assert_same_plane(port, ref, sealed=False)
    assert port.generation == ref.generation == 2


def test_tiers_hotness_and_wal_hook(anns):
    ref, port = planes(anns)
    rng = np.random.default_rng(8)
    probes = rng.integers(-1, 8, size=(20, 3))
    for plane in (ref, port):
        plane.note_probes(0, probes)
        plane.note_probes(0, probes[:5])
        plane.note_probes(99, probes)               # unknown segment: ignored
    np.testing.assert_array_equal(port.hotness(0), ref.hotness(0))
    np.testing.assert_array_equal(port.hotness(99), ref.hotness(99))
    assert port.set_tiers({0: "host", 7: "host"}) == ref.set_tiers({0: "host", 7: "host"})
    assert port.tiers() == ref.tiers() == {0: "host"}
    assert port.snapshot().tiers == {0: "host"} and port.snapshot().placement_version == 1
    with pytest.raises(ValueError, match="tier"):
        port.set_tiers({0: "disk"})

    class Log:
        def __init__(self):
            self.records = []

        def append_upsert(self, ids, vecs, meta_rows):
            self.records.append(("upsert", ids.tolist(), meta_rows))
            return len(self.records)

        def append_delete(self, ids):
            self.records.append(("delete", ids.tolist()))
            return len(self.records)

    log = Log()
    port.attach_wal(log)
    port.upsert([1, 2], np.ones((2, DIM), np.float32), meta={"c": [1, 2]})
    port.delete([1])
    assert port.wal_seq == 2
    assert log.records == [("upsert", [1, 2], [{"c": 1}, {"c": 2}]), ("delete", [1])]
    port.attach_wal(None)
    port.delete([2])
    assert len(log.records) == 2


def test_metadata_parity(anns):
    ds, cfg = anns
    rng = np.random.default_rng(9)
    n = ds.nb
    meta = {"color": rng.integers(0, 4, size=n), "price": rng.uniform(0, 100, size=n),
            "text": [f"doc {i}" if i % 3 else None for i in range(n)]}
    rows = [None if i % 5 == 0 else {"color": int(i % 3), "size": 1.5 * i}
            for i in range(n)]
    for m in (meta, rows, None):
        assert meta_rows_from_batch(m, n) == r_meta_rows(m, n)
        tstore = meta_rows_to_store(meta_rows_from_batch(m, n))
        rstore = r_meta_store(r_meta_rows(m, n))
        assert (tstore is None) == (rstore is None)
        if tstore is not None:
            assert tstore.tags.keys() == rstore.tags.keys()
            for name in rstore.tags:
                np.testing.assert_array_equal(tstore.tags[name], rstore.tags[name])
            for name in rstore.nums:
                np.testing.assert_array_equal(tstore.nums[name], rstore.nums[name])
            assert tstore.texts == rstore.texts and tstore.n == rstore.n
            assert [tstore.row(r) for r in range(0, n, 37)] == \
                [rstore.row(r) for r in range(0, n, 37)]
    with pytest.raises(ValueError):
        meta_rows_from_batch({"c": [1, 2]}, 3)
    with pytest.raises(ValueError, match="text"):
        meta_rows_to_store([{"name": "x"}])
    assert TAG_MISSING == np.iinfo(np.int64).min
    # build_ivf permutes the metadata with the rows, as the reference does
    ref = r_build(ds.x, cfg, meta=meta)
    port = build_ivf(ds.x, HarmonyConfig(**dataclasses.asdict(cfg)), meta=meta,
                     centers=ref.centers, device="cpu")
    np.testing.assert_array_equal(port.ids, ref.ids)
    for name in ref.meta.tags:
        np.testing.assert_array_equal(port.meta.tags[name], ref.meta.tags[name])
    np.testing.assert_array_equal(port.meta.nums["price"], ref.meta.nums["price"])
    assert port.meta.texts == ref.meta.texts
    again = build_ivf(ds.x, HarmonyConfig(**dataclasses.asdict(cfg)), meta=port.meta,
                      centers=ref.centers, device="cpu")
    assert again.meta.texts == port.meta.select(port.ids).texts
    carried = ivf_from_arrays(dataclasses.asdict(cfg), ivf_arrays(ref), device="cpu")
    assert carried.meta.texts == ref.meta.texts
    np.testing.assert_array_equal(carried.meta.tags["color"], ref.meta.tags["color"])
