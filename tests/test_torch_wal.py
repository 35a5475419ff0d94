"""The port's write-ahead log, checkpointer and crash recovery (CPU).

Mirrors every test of ``tests/test_wal.py`` through ``repro_torch`` with
``device="cpu"``, then holds the two packages against each other: the
same writes give byte-identical WAL files; a checkpoint plus WAL written
by either package recovers in the other and searches as the writer's
plane does (nprobe = nlist, so search is exact); a checkpoint tree's keys
and bf16 leaves read the same both ways.
"""

import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RCheckpointer
from repro.checkpoint import WriteAheadLog as RWal
from repro.checkpoint import checkpoint_segmented_index as r_checkpoint
from repro.checkpoint import recover_segmented_index as r_recover
from repro.config import HarmonyConfig as RCfg
from repro.core import SegmentedIndex as RSegmented
from repro.serve import HarmonyServer as RServer
from repro_torch.checkpoint import (
    Checkpointer,
    WriteAheadLog,
    checkpoint_segmented_index,
    load_segmented_index,
    read_wal,
    recover_segmented_index,
    replay_wal_into,
    save_segmented_index,
)
from repro_torch.config import HarmonyConfig
from repro_torch.core import SegmentedIndex
from repro_torch.runtime.faults import FaultSpec, InjectedFault, fault_scope
from repro_torch.serve import HarmonyServer
from test_executor import assert_matches_oracle
from test_torch_segments import assert_same_plane, port_plane

CFG = HarmonyConfig(dim=8, nlist=4, nprobe=4, topk=4, kmeans_iters=2)


def _plane(seed=0, nb=64):
    rng = np.random.default_rng(seed)
    return SegmentedIndex.build(
        rng.standard_normal((nb, 8)).astype(np.float32), CFG, device="cpu"
    ), rng


def _assert_same_live_set(data, model: dict, deleted: set):
    for i in model:
        assert data.has(i), f"acknowledged id {i} lost"
    for i in deleted:
        if i not in model:
            assert not data.has(i), f"deleted id {i} resurfaced"


# ------------------------------------------------------------------ framing
def test_wal_roundtrip(tmp_path):
    wal = WriteAheadLog(tmp_path, sync=False)
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert wal.append_upsert(np.array([5, 6, 7]), v) == 1
    assert wal.append_delete(np.array([6])) == 2
    wal.close()
    r = read_wal(wal.path)
    assert not r.torn_tail and r.last_seq == 2
    up, de = r.records
    assert up.kind == "upsert" and de.kind == "delete"
    np.testing.assert_array_equal(up.ids, [5, 6, 7])
    np.testing.assert_array_equal(up.vecs, v)
    np.testing.assert_array_equal(de.ids, [6])
    assert de.vecs is None


def test_wal_torn_tail_at_every_byte(tmp_path):
    """Truncating the file anywhere inside the final record yields the
    intact prefix: never garbage, never a lost earlier record."""
    wal = WriteAheadLog(tmp_path, sync=False)
    wal.append_upsert(np.array([1]), np.ones((1, 4), np.float32))
    wal.append_delete(np.array([2, 3]))
    wal.append_upsert(np.array([4]), np.full((1, 4), 2, np.float32))
    wal.close()
    blob = wal.path.read_bytes()
    full = read_wal(wal.path)
    assert [rec.seq for rec in full.records] == [1, 2, 3]
    second_end = full.records[1].end_offset
    for cut in range(second_end, len(blob)):
        wal.path.write_bytes(blob[:cut])
        r = read_wal(wal.path)
        assert [rec.seq for rec in r.records] == [1, 2]
        assert r.torn_tail == (cut > second_end)
        assert r.valid_bytes == second_end


def test_wal_reopen_repairs_and_continues_seq(tmp_path):
    wal = WriteAheadLog(tmp_path, sync=False)
    wal.append_upsert(np.array([1]), np.ones((1, 4), np.float32))
    wal.append_upsert(np.array([2]), np.ones((1, 4), np.float32))
    wal.close()
    blob = wal.path.read_bytes()
    wal.path.write_bytes(blob[:-5])               # tear record 2
    wal2 = WriteAheadLog(tmp_path, sync=False)
    assert wal2.last_seq == 1
    assert wal2.append_delete(np.array([9])) == 2
    wal2.close()
    r = read_wal(wal2.path)
    assert not r.torn_tail
    assert [(rec.seq, rec.kind) for rec in r.records] == [(1, "upsert"), (2, "delete")]


def test_wal_torn_write_injection(tmp_path):
    """A kind="torn" fault persists a partial frame then dies: the write is
    unacknowledged, and recovery treats it as never written."""
    wal = WriteAheadLog(tmp_path, sync=False)
    wal.append_upsert(np.array([1]), np.ones((1, 4), np.float32))
    with fault_scope(FaultSpec("wal.append", kind="torn")):
        with pytest.raises(InjectedFault):
            wal.append_upsert(np.array([2]), np.ones((1, 4), np.float32))
    wal.close()
    r = read_wal(wal.path)
    assert r.torn_tail and [rec.seq for rec in r.records] == [1]
    wal2 = WriteAheadLog(tmp_path, sync=False)
    assert wal2.append_delete(np.array([1])) == 2
    wal2.close()
    r2 = read_wal(wal2.path)
    assert not r2.torn_tail and r2.last_seq == 2


# ----------------------------------------------------------------- rotation
def test_rotation_prunes_only_covered_files(tmp_path):
    wal = WriteAheadLog(tmp_path, sync=False)
    wal.append_upsert(np.array([1]), np.ones((1, 4), np.float32))
    wal.append_upsert(np.array([2]), np.ones((1, 4), np.float32))
    wal.rotate(step=1, prune_up_to_seq=1)       # record 2 not covered
    assert len(wal.files()) == 2
    wal.append_delete(np.array([2]))
    wal.rotate(step=2, prune_up_to_seq=3)       # everything covered
    assert [p.name for p in wal.files()] == ["wal_000000002.log"]
    wal.close()


def test_checkpoint_and_recover_equals_oracle(tmp_path):
    data, rng = _plane()
    ckpt = Checkpointer(tmp_path / "ckpt", keep=3)
    wal = WriteAheadLog(tmp_path / "wal", sync=False)
    data.attach_wal(wal)
    model = {i: None for i in range(64)}
    deleted = set()

    def upsert(ids):
        vecs = rng.standard_normal((len(ids), 8)).astype(np.float32)
        data.upsert(np.asarray(ids, np.int64), vecs)
        for j, i in enumerate(ids):
            model[i] = vecs[j]
            deleted.discard(i)

    def delete(ids):
        data.delete(np.asarray(ids, np.int64))
        for i in ids:
            model.pop(i, None)
            deleted.add(i)

    upsert([100, 101])
    delete([0, 1])
    checkpoint_segmented_index(ckpt, data, wal)     # durable point
    upsert([102])
    delete([100, 2])
    upsert([2])                                     # resurrect id 2
    wal.close()                                     # crash here

    data2, wal2, report = recover_segmented_index(
        ckpt, tmp_path / "wal", cfg=CFG, sync=False, device="cpu"
    )
    assert report["replayed"] == 3 and not report["torn_tail"]
    assert data2.wal_seq == data.wal_seq and data2.device.type == "cpu"
    _assert_same_live_set(data2, model, deleted)
    srv = HarmonyServer(data2, n_nodes=2, device="cpu")
    res = srv.search_batch(model[2][None], k=1)
    assert int(res.ids[0, 0]) == 2
    assert float(res.scores[0, 0]) < 1e-6
    data2.upsert(np.array([500]), rng.standard_normal((1, 8)).astype(np.float32))
    assert wal2.last_seq == data2.wal_seq
    wal2.close()


def test_recover_without_checkpoint_cold_start(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal", sync=False)
    wal.append_upsert(np.array([7]), np.ones((1, 8), np.float32))
    wal.close()
    ckpt = Checkpointer(tmp_path / "ckpt")
    with pytest.warns(UserWarning, match="recovering from WAL alone"):
        data, wal2, report = recover_segmented_index(
            ckpt, tmp_path / "wal", cfg=CFG, sync=False, device="cpu"
        )
    assert report["replayed"] == 1 and data.has(7)
    wal2.close()
    with pytest.raises(FileNotFoundError):
        recover_segmented_index(Checkpointer(tmp_path / "ckpt2"), tmp_path / "wal",
                                device="cpu")


def test_replay_refuses_attached_wal(tmp_path):
    data, _ = _plane()
    wal = WriteAheadLog(tmp_path, sync=False)
    data.attach_wal(wal)
    with pytest.raises(RuntimeError, match="detach"):
        replay_wal_into(data, tmp_path)
    wal.close()


# ----------------------------------------------------- checkpointer atomics
def test_checkpointer_crash_atomic_write_and_publish(tmp_path):
    """A crash inside the checkpoint write or in the publish window never
    leaves a corrupt step dir; reads fall back to the previous step, and
    the next save of the same step sweeps the litter."""
    ckpt = Checkpointer(tmp_path, keep=3)
    tree0 = {"w": np.arange(4, dtype=np.float32)}
    ckpt.save(0, tree0)
    for site in ("checkpoint.write", "checkpoint.publish"):
        with fault_scope(FaultSpec(site, kind="crash", where={"step": 1})):
            with pytest.raises(InjectedFault):
                ckpt.save(1, {"w": np.full(4, 9, np.float32)})
        assert ckpt.all_steps() == [0], site
        _, arrays = ckpt.load_arrays()
        np.testing.assert_array_equal(arrays["w"], tree0["w"])
    ckpt.save(1, {"w": np.full(4, 7, np.float32)})
    assert ckpt.all_steps() == [0, 1]
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert not list(tmp_path.glob(".old_step_*"))
    _, arrays = ckpt.load_arrays()
    np.testing.assert_array_equal(arrays["w"], np.full(4, 7, np.float32))


def test_checkpointer_overwrite_publish_crash_keeps_old_copy(tmp_path):
    """Re-saving an existing step crashes between the two renames: the old
    copy was moved aside, not deleted, and is renamed back."""
    ckpt = Checkpointer(tmp_path, keep=3)
    ckpt.save(0, {"w": np.zeros(2, np.float32)})
    ckpt.save(1, {"w": np.ones(2, np.float32)})
    with fault_scope(FaultSpec("checkpoint.publish", kind="crash", where={"step": 1})):
        with pytest.raises(InjectedFault):
            ckpt.save(1, {"w": np.full(2, 5, np.float32)})
    assert ckpt.all_steps() == [0]
    with pytest.warns(UserWarning, match="interrupted overwrite"):
        _, arrays = ckpt.load_arrays()
    np.testing.assert_array_equal(arrays["w"], np.ones(2, np.float32))
    assert ckpt.all_steps() == [0, 1]


def test_checkpointer_publish_crash_on_only_step_is_recoverable(tmp_path):
    """Overwriting the only step and crashing mid-publish leaves no step
    dir; the moved-aside copy is restored, and a later save's sweep does
    not destroy it."""
    ckpt = Checkpointer(tmp_path, keep=3)
    ckpt.save(0, {"w": np.zeros(2, np.float32)})
    with fault_scope(FaultSpec("checkpoint.publish", kind="crash")):
        with pytest.raises(InjectedFault):
            ckpt.save(0, {"w": np.ones(2, np.float32)})
    assert ckpt.all_steps() == []
    with pytest.warns(UserWarning, match="interrupted overwrite"):
        _, arrays = ckpt.load_arrays()
    np.testing.assert_array_equal(arrays["w"], np.zeros(2, np.float32))
    ckpt.save(0, {"w": np.full(2, 7, np.float32)})
    _, arrays = ckpt.load_arrays()
    np.testing.assert_array_equal(arrays["w"], np.full(2, 7, np.float32))


def test_load_arrays_skips_unreadable_step_with_warning(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=3)
    ckpt.save(0, {"w": np.zeros(2, np.float32)})
    ckpt.save(1, {"w": np.ones(2, np.float32)})
    (tmp_path / "step_000000001" / "arrays.npz").write_bytes(b"garbage")
    with pytest.warns(UserWarning, match="skipping unreadable"):
        _, arrays = ckpt.load_arrays()
    np.testing.assert_array_equal(arrays["w"], np.zeros(2, np.float32))
    with pytest.raises(Exception):
        ckpt.load_arrays(step=1)
    with pytest.warns(UserWarning, match="skipping unreadable"):
        out = ckpt.restore({"w": np.zeros(2, np.float32)}, device="cpu")
    assert isinstance(out["w"], torch.Tensor) and out["w"].dtype == torch.float32
    np.testing.assert_array_equal(out["w"].numpy(), np.zeros(2))


def test_async_checkpoint_crash_is_surfaced(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=3, async_write=True)
    ckpt.save(0, {"w": np.zeros(2, np.float32)})
    ckpt.wait()
    with fault_scope(FaultSpec("checkpoint.write", kind="crash")):
        with pytest.warns(UserWarning, match="async checkpoint write failed"):
            ckpt.save(1, {"w": np.ones(2, np.float32)})
            ckpt.wait()
    assert ckpt.errors and "InjectedFault" in ckpt.errors[0]
    assert ckpt.all_steps() == [0]


# ------------------------------------------------------ across the packages
def _writes(rng, dim):
    """One write sequence: upserts with and without metadata, deletes."""
    return [
        ("upsert", np.array([5, 6, 7]), rng.standard_normal((3, dim)).astype(np.float32), None),
        ("delete", np.array([6, 99]), None, None),
        ("upsert", np.array([8, 9]), rng.standard_normal((2, dim)).astype(np.float32),
         [{"color": 1, "text": "red shoe"}, None]),
        ("upsert", np.array([10]), rng.standard_normal((1, dim)).astype(np.float32),
         [None]),
        ("delete", np.array([5]), None, None),
    ]


def _apply(wal, writes):
    for kind, ids, vecs, meta in writes:
        if kind == "upsert":
            wal.append_upsert(ids, vecs, meta)
        else:
            wal.append_delete(ids)


def test_wal_bytes_equal_across_packages(tmp_path):
    """The same writes give the same log file, byte for byte, and each
    package reads the other's records; a torn tail is cut the same way."""
    writes = _writes(np.random.default_rng(0), 8)
    for name, cls in (("port", WriteAheadLog), ("ref", RWal)):
        wal = cls(tmp_path / name, sync=False)
        _apply(wal, writes)
        wal.close()
    port_blob = (tmp_path / "port" / "wal_000000000.log").read_bytes()
    ref_blob = (tmp_path / "ref" / "wal_000000000.log").read_bytes()
    assert port_blob == ref_blob
    from repro.checkpoint import read_wal as r_read

    mine, theirs = read_wal(tmp_path / "ref" / "wal_000000000.log"), \
        r_read(tmp_path / "port" / "wal_000000000.log")
    assert [(a.seq, a.kind, a.end_offset, a.meta) for a in mine.records] == \
        [(b.seq, b.kind, b.end_offset, b.meta) for b in theirs.records]
    for a, b in zip(mine.records, theirs.records):
        np.testing.assert_array_equal(a.ids, b.ids)
        if a.vecs is not None:
            np.testing.assert_array_equal(a.vecs, b.vecs)
    for name, cls in (("port", WriteAheadLog), ("ref", RWal)):
        path = tmp_path / name / "wal_000000000.log"
        path.write_bytes(port_blob[:-3])
        cls(tmp_path / name, sync=False).close()      # reopening repairs
    assert (tmp_path / "port" / "wal_000000000.log").read_bytes() == \
        (tmp_path / "ref" / "wal_000000000.log").read_bytes()


def _ref_pair(seed=0, nb=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, 8)).astype(np.float32)
    cfg = RCfg(dim=8, nlist=4, nprobe=4, topk=4, kmeans_iters=2)
    ref = RSegmented.build(x, cfg)
    return x, rng, ref, port_plane(ref)


def _durable_history(pkg, data, root, rng_seed):
    """Attach a WAL, write, seal, tier and heat a segment, checkpoint, then
    write more: the last writes live only in the WAL. Returns the wal."""
    mod = {"port": (Checkpointer, WriteAheadLog, checkpoint_segmented_index),
           "ref": (RCheckpointer, RWal, r_checkpoint)}[pkg]
    ckpt_cls, wal_cls, ckpt_fn = mod
    rng = np.random.default_rng(rng_seed)
    ckpt = ckpt_cls(root / "ckpt", keep=2)
    wal = wal_cls(root / "wal", sync=False)
    data.attach_wal(wal)
    data.upsert(np.arange(1000, 1012), rng.standard_normal((12, 8)).astype(np.float32),
                meta={"color": np.arange(12) % 3,
                      "text": [f"doc {i} word{i % 4}" for i in range(12)]})
    data.delete([0, 1, 1003])
    data.compact_inline()                       # a second, quantized segment
    data.note_probes(0, np.array([[0, 1], [2, 3]]))
    data.set_tiers({data.segments[-1].seg_id: "host"})
    data.upsert([2000, 2], rng.standard_normal((2, 8)).astype(np.float32),
                meta=[{"color": 2}, None])
    ckpt_fn(ckpt, data, wal)
    data.upsert([3000], rng.standard_normal((1, 8)).astype(np.float32))
    data.delete([2000, 5])
    wal.close()
    return wal


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_and_wal_recover_in_the_other_package(tmp_path, writer):
    """A checkpoint (sealed segments with int8 codes, metadata and texts,
    tombstones, delta rows with metadata, tiers, hotness, the WAL
    watermark) plus a WAL tail written by one package recovers in the
    other to the same plane, and searches as the writer's plane does."""
    x, _, ref, port = _ref_pair()
    writer_plane = ref if writer == "ref" else port
    _durable_history(writer, writer_plane, tmp_path, rng_seed=4)
    if writer == "ref":
        got, wal, report = recover_segmented_index(
            Checkpointer(tmp_path / "ckpt"), tmp_path / "wal", sync=False, device="cpu")
    else:
        got, wal, report = r_recover(RCheckpointer(tmp_path / "ckpt"), tmp_path / "wal",
                                     sync=False)
    wal.close()
    assert report["replayed"] == 2 and not report["torn_tail"]
    writer_plane.attach_wal(None)
    assert got.wal_seq == writer_plane.wal_seq
    assert got.tiers() == writer_plane.tiers()
    assert got.placement_version == writer_plane.placement_version
    np.testing.assert_array_equal(got.hotness(0), writer_plane.hotness(0))
    assert_same_plane(got, writer_plane, sealed=False)
    quantized = [s.index.__dict__.get("_int8_quants", {}).get(s.index.cfg.quant_blocks)
                 for s in writer_plane.segments]
    assert quantized[-1] is not None              # the seal made the codes
    for a, qb in zip(got.segments, quantized):
        qa = a.index.__dict__.get("_int8_quants", {}).get(a.index.cfg.quant_blocks)
        assert (qa is None) == (qb is None)
        if qb is not None:
            np.testing.assert_array_equal(qa.codes, qb.codes)
            np.testing.assert_array_equal(qa.scale, qb.scale)
            np.testing.assert_array_equal(qa.zero, qb.zero)
    seg = got.segments[-1].index
    assert seg.meta is not None and seg.meta.texts is not None
    q = x[:6] + 0.01
    if writer == "ref":
        mine = HarmonyServer(got, n_nodes=2, device="cpu")
        theirs = RServer(writer_plane, n_nodes=2)
    else:
        mine = RServer(got, n_nodes=2)
        theirs = HarmonyServer(writer_plane, n_nodes=2, device="cpu")
    assert_matches_oracle(mine.search_batch(q, k=4), theirs.search_batch(q, k=4))


def test_segmented_index_round_trip(tmp_path):
    """``save_segmented_index`` / ``load_segmented_index`` in the port:
    the same plane back, searching identically, fully mutable."""
    x, rng, _, port = _ref_pair(seed=1)
    port.upsert(np.arange(500, 520), rng.standard_normal((20, 8)).astype(np.float32))
    port.compact_inline()
    port.delete([40, 505])
    port.upsert([31_000], rng.standard_normal((1, 8)).astype(np.float32))
    ck = Checkpointer(tmp_path / "ckpt")
    save_segmented_index(ck, port)
    assert ck.latest_step() == port.generation
    back = load_segmented_index(ck, device="cpu")
    assert (back.generation, back.n_segments, back.nb_live, back.op_count) == (
        port.generation, port.n_segments, port.nb_live, port.op_count)
    assert_same_plane(back, port, sealed=False)
    q = x[:8]
    a = HarmonyServer(port, n_nodes=4, device="cpu").search_batch(q, k=5)
    b = HarmonyServer(back, n_nodes=4, device="cpu").search_batch(q, k=5)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    back.delete([41])
    back.compact_inline(merge_all=True)
    assert back.n_segments == 1 and not back.has(41)


def test_checkpoint_tree_keys_and_bf16_across_packages(tmp_path):
    """Tree flattening gives the reference's keys (sorted dict keys,
    sequence positions, ``None`` dropped), so a step written by either
    package restores in the other; a bf16 leaf round-trips both ways."""
    import ml_dtypes

    tree = {"b": [np.arange(3, dtype=np.int32), None,
                  (np.ones((2, 2), np.float32), {"z": np.float64(1.5), "a": np.int64(2)})],
            "a": {"y": None, "x": np.zeros(4, np.float32)},
            "seg/0": np.arange(5, dtype=np.int64)}
    bf = np.array([1.5, -2.25, 3.0], np.float32)
    Checkpointer(tmp_path / "port").save(3, {**tree, "h": torch.tensor(bf).to(torch.bfloat16)})
    RCheckpointer(tmp_path / "ref").save(3, {**tree, "h": bf.astype(ml_dtypes.bfloat16)})
    keys = ["a/x", "b/0", "b/2/0", "b/2/1/a", "b/2/1/z", "h", "seg/0"]
    _, mine = Checkpointer(tmp_path / "ref").load_arrays()
    _, theirs = RCheckpointer(tmp_path / "port").load_arrays()
    assert sorted(mine) == sorted(theirs) == keys
    assert theirs["h"].dtype.name == "bfloat16"           # the manifest names it
    np.testing.assert_array_equal(theirs["h"].astype(np.float32), bf)
    like = {**tree, "h": torch.zeros(3, dtype=torch.bfloat16)}
    back = Checkpointer(tmp_path / "ref").restore(like, device="cpu")
    assert back["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["h"].float().numpy(), bf)
    assert back["a"]["y"] is None and back["b"][1] is None
    assert isinstance(back["b"][2], tuple) and back["b"][2][1]["a"].item() == 2
    np.testing.assert_array_equal(back["seg/0"].numpy(), tree["seg/0"])
    r_back = RCheckpointer(tmp_path / "port").restore(
        {**tree, "h": np.zeros(3, ml_dtypes.bfloat16)})
    np.testing.assert_array_equal(np.asarray(r_back["h"]).astype(np.float32), bf)


def test_restore_device_and_no_resharding(tmp_path):
    """``restore`` puts tensors on the card unless asked (``device=None``
    is CUDA, and raises without one); ``shardings=`` has no counterpart on
    one card and raises ``ValueError``."""
    ckpt = Checkpointer(tmp_path)
    ckpt.save(0, {"w": np.arange(3, dtype=np.float32)})
    with pytest.raises(ValueError, match="shardings"):
        ckpt.restore({"w": np.zeros(3, np.float32)}, shardings={"w": None}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.restore({"w": np.zeros(3, np.float32)})
        with pytest.raises(RuntimeError, match="CUDA"):
            load_segmented_index(ckpt)
    out = ckpt.restore({"w": torch.zeros(3, dtype=torch.float64)}, device="cpu")
    assert out["w"].dtype == torch.float64 and out["w"].tolist() == [0.0, 1.0, 2.0]
