"""The port's host tier (CPU): a segment set to ``"host"`` is served by an
executor that keeps its packed arrays in host memory and streams each
batch's probed rows, bit-identically to the device tier.

Mirrors of ``tests/test_tiered.py``'s tier-invariant serving and prefetch
cases. A tier move here runs the mechanism's own sequence, the one
``apply_placement`` runs: ``srv.prepare_placement(tiers)``,
``data.set_tiers(tiers)``, ``srv.adopt()``; the placement policy itself
is tested in ``tests/test_torch_placement.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import SegmentedIndex as RSegmented
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import HarmonyServer as RServer
from repro_torch.config import HarmonyConfig
from repro_torch.core import SegmentedIndex, search_oracle
from repro_torch.core.pipeline import gather_host_candidates, gather_local_candidates
from repro_torch.serve import ExecutorConfig, HarmonyServer, SpmdExecutor
from test_executor import assert_matches_oracle
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


def place(data, servers, tiers):
    """``apply_placement``'s sequence: prepare, swap, adopt."""
    for srv in servers:
        srv.prepare_placement(tiers)
    data.set_tiers(tiers)
    for srv in servers:
        srv.adopt()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_demote_promote_bit_identical_roundtrip(precision):
    x, data = _plane()
    srv = HarmonyServer(data, n_nodes=2, backend="spmd", precision=precision, device="cpu")
    q = _queries(x)
    hot = srv.search_batch(q)
    assert hot.stats["cold_segments"] == 0
    demote = {s.seg_id: "host" for s in data.segments}
    srv.prepare_placement(demote)
    assert set(srv._staged) == set(demote)                 # built off the path
    assert all(st.tier == "host" and st.executors for st in srv._staged.values())
    # the warmed ladder leaves no candidate buffers on the device
    assert not any(sets for st in srv._staged.values()
                   for sets in st.executors[precision]._cand_pool.values())
    data.set_tiers(demote)
    srv.adopt()
    assert all(st.tier == "host" for st in srv._seg_states.values())
    cold = srv.search_batch(q)
    assert cold.stats["cold_segments"] == data.n_segments
    assert cold.stats["bytes_streamed"] > 0
    np.testing.assert_array_equal(hot.ids, cold.ids)
    np.testing.assert_array_equal(hot.scores, cold.scores)
    assert srv.stats.cold_batches == 1
    assert srv.stats.bytes_streamed == cold.stats["bytes_streamed"]
    place(data, [srv], {s.seg_id: "device" for s in data.segments})
    hot2 = srv.search_batch(q)
    assert hot2.stats["cold_segments"] == 0
    np.testing.assert_array_equal(hot.ids, hot2.ids)
    np.testing.assert_array_equal(hot.scores, hot2.scores)


@pytest.mark.parametrize("backend", ["host", "spmd"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_host_tier_matches_oracle(backend, precision):
    cfg = CFG.replace(nprobe=8)              # all clusters: exact
    x, data = _plane(cfg=cfg, extra=0)       # single segment vs oracle
    data.set_tiers({data.segments[0].seg_id: "host"})
    srv = HarmonyServer(data, n_nodes=2, backend=backend, precision=precision,
                        device="cpu")
    q = _queries(x)
    res = srv.search_batch(q)
    ref = search_oracle(data.segments[0].index, q, k=cfg.topk)
    np.testing.assert_array_equal(res.ids, ref.ids)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=1e-5, atol=1e-5)
    assert res.stats["cold_segments"] == (backend == "spmd")


def test_tier_moves_do_not_bump_generation():
    x, data = _plane()
    srv = HarmonyServer(data, n_nodes=2, backend="spmd", device="cpu")
    gen, swaps = srv.generation, srv.stats.generation_swaps
    place(data, [srv], {s.seg_id: "host" for s in data.segments})
    srv.search_batch(_queries(x))
    assert srv.generation == gen
    assert srv.stats.generation_swaps == swaps
    assert srv.stats.placement_swaps == 1


def test_prefetch_hits_and_lookahead():
    x, data = _plane()
    data.set_tiers({s.seg_id: "host" for s in data.segments})
    srv = HarmonyServer(data, n_nodes=2, backend="spmd", device="cpu")
    q = _queries(x, n=8)
    srv.prefetch_batch(q)
    res = srv.search_batch(q)
    assert res.stats["prefetch_hits"] == data.n_segments
    assert srv.stats.prefetch_hits == data.n_segments
    # lookahead, as the scheduler drives it: stage batch i+1, serve batch i
    batches = [q[i:i + 2] for i in range(0, 8, 2)]
    hits0 = srv.stats.prefetch_hits
    srv.prefetch_batch(batches[0])
    for i, b in enumerate(batches):
        if i + 1 < len(batches):
            srv.prefetch_batch(batches[i + 1])
        got = srv.search_batch(b)
        np.testing.assert_array_equal(got.ids, res.ids[2 * i:2 * i + 2])
        np.testing.assert_array_equal(got.scores, res.scores[2 * i:2 * i + 2])
    assert srv.stats.prefetch_hits - hits0 == len(batches) * data.n_segments
    ex = srv._seg_states[data.segments[0].seg_id].executors["fp32"]
    summary = ex.stats_summary()
    assert summary["tier"] == "host" and summary["prefetch_staged"] == 1 + len(batches)
    assert summary["cold_dispatches"] == 1 + len(batches)
    # a wrong prediction is a miss, never a wrong answer; two slots at most
    for b in batches[:3]:
        srv.prefetch_batch(b + 1.0)
    assert 1 <= len(ex._prefetched) <= 2
    miss0 = ex.prefetch_misses
    got = srv.search_batch(q)
    np.testing.assert_array_equal(got.ids, res.ids)
    assert ex.prefetch_misses == miss0 + 1 and got.stats["prefetch_hits"] == 0
    # at most three buffer sets stay (two staged slots and the batch in
    # flight), all of the buckets in use
    assert sum(len(p) for p in ex._cand_pool.values()) <= 3


def test_host_gather_equals_device_gather():
    """The host-side gather gives the device-side gather's arrays bit for
    bit, pad slots (-1) included, into preallocated buffers."""
    _, data = _plane(extra=0)
    ex = SpmdExecutor(data.segments[0].index, ExecutorConfig(d_blocks=2, chunk=64),
                      mesh=(2, 2), tier="host", device="cpu")
    dev = SpmdExecutor(data.segments[0].index, ExecutorConfig(d_blocks=2, chunk=64),
                       mesh=(2, 2), device="cpu")
    probes = np.array([[0, 3], [5, 6]], np.int32)
    rows, cap_b = dev._gather_rows(probes)
    assert (rows < 0).any()
    res = dev._resident
    want = gather_local_candidates(
        torch.as_tensor(rows.astype(np.int64)), res["x_blk"],
        res["xn2_blk"], res["cluster_ids"], res["row_ids"])
    got = gather_host_candidates(ex._host_arrays, rows)
    for name, w in zip(("x_c", "xn2_c", "cl_c", "id_c"), want):
        assert got[name].dtype == w.dtype and got[name].shape == w.shape
        assert got[name].numpy().tobytes() == w.numpy().tobytes(), name
    up = ex._upload_candidates(rows, cap_b)
    assert up.nbytes == sum(t.nbytes for t in got.values())
    assert ex._resident is None and up.buf.dev["x_c"].shape == got["x_c"].shape


@pytest.mark.parametrize("tier", ["device", "host"])
def test_a_dropped_executor_is_freed_at_once(tier):
    """No reference cycle holds an executor (its step closures do not
    refer to it), so a tier move frees the old tier's arrays when the
    server lets go of them, not at a later garbage collection."""
    import gc
    import weakref

    _, data = _plane(extra=0)
    ex = SpmdExecutor(data.segments[0].index, ExecutorConfig(chunk=64), tier=tier,
                      device="cpu")
    ex.search_batch(_queries(data.segments[0].index.x.numpy()))
    ref = weakref.ref(ex)
    gc.disable()
    try:
        del ex
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_host_tier_matches_reference_host_tier(precision):
    """The port's host-tier server against the reference's on the same
    plane (carried across): equal results and equal streamed bytes."""
    rng = np.random.default_rng(0)
    rcfg = RCfg(dim=16, nlist=8, nprobe=4, topk=5, kmeans_iters=3)
    x = rng.standard_normal((576, 16)).astype(np.float32)
    ref = RSegmented.build(x[:384], rcfg)
    ref.upsert(np.arange(384, 576), x[384:])
    ref.compact_inline()
    tiers = {s.seg_id: "host" for s in ref.segments}
    ref.set_tiers(tiers)
    t_plane = port_plane(ref)
    t_plane.set_tiers(tiers)
    ecfg = dict(qb_buckets=(8,), chunk=64)
    r = RServer(ref, n_nodes=2, backend="spmd", precision=precision,
                executor_cfg=RExCfg(use_pallas=False, **ecfg))
    t = HarmonyServer(t_plane, n_nodes=2, backend="spmd", precision=precision,
                      executor_cfg=ExecutorConfig(**ecfg), device="cpu")
    q = _queries(x)
    rr, tr = r.search_batch(q), t.search_batch(q)
    assert_matches_oracle(tr, rr)
    assert tr.stats["cold_segments"] == rr.stats["cold_segments"] == 2
    assert tr.stats["bytes_streamed"] == rr.stats["bytes_streamed"]
    assert dataclasses.asdict(t.stats)["cold_batches"] == r.stats.cold_batches == 1


@pytest.mark.cuda
def test_cuda_host_tier_streams_bit_identically():
    """On the card: pinned host arrays, the side-stream upload and its
    event; demoted results equal the device tier's bit for bit, and the
    host tier holds no rows on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    data = SegmentedIndex.build(x, CFG, device="cuda")
    srv = HarmonyServer(data, n_nodes=2, device="cuda")
    q = _queries(x, n=40)
    hot = srv.search_batch(q)
    place(data, [srv], {0: "host"})
    ex = srv._seg_states[0].executors["fp32"]
    assert ex._resident is None and ex._host_arrays["x_blk"].is_pinned()
    srv.prefetch_batch(q)
    cold = srv.search_batch(q)
    np.testing.assert_array_equal(hot.ids, cold.ids)
    np.testing.assert_array_equal(hot.scores, cold.scores)
    assert cold.stats["prefetch_hits"] == 1 and ex.upload_ms > 0
