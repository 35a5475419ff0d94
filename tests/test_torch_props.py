"""Property tests P7, P8, P9 and P10 of ``tests/properties/test_props.py``
through the port (CPU), with the reference's own hypothesis settings.

  P7  arbitrary interleavings of upsert/delete/seal/merge on the mutable
      segmented data plane match a brute-force oracle over the live
      vector set on both serving backends;
  P8  the fused-kernel ``merge_topk`` equals the host heap merge for any
      part layout, external ids beyond int32 included;
  P9  a crash at any instant (a torn WAL record, any compactor phase
      boundary, the checkpoint write or publish window) recovers from disk
      to exactly the acknowledged writes: none lost, none resurrected;
  P10 filtered search is exact: random per-row metadata and random filter
      trees, served at full coverage, equal the brute force restricted to
      the filter's allowed set, on both backends and in both precisions,
      across seal and merge, with tombstones.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need the hypothesis extra")
from hypothesis import given, settings, strategies as st

from repro_torch.config import HarmonyConfig
from repro_torch.core import TAG_MISSING, NumRange, SearchRequest, SegmentedIndex, TagIn
from repro_torch.core import merge_topk
from repro_torch.serve import ExecutorConfig, HarmonyServer

SETTINGS = dict(max_examples=15, deadline=None)


def exact_scores(x: np.ndarray, q: np.ndarray, metric: str = "l2") -> np.ndarray:
    """The brute force's L2 scores [NQ, N] in numpy."""
    assert metric == "l2"
    return (q * q).sum(1)[:, None] - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]


def _server(data, backend):
    return HarmonyServer(data, n_nodes=2, backend=backend,
                         executor_cfg=ExecutorConfig(qb_buckets=(8,), chunk=64),
                         device="cpu")


@given(
    data_seed=st.integers(0, 50),
    backend=st.sampled_from(["host", "spmd"]),
    ops=st.lists(
        st.tuples(
            st.sampled_from(["insert", "overwrite", "delete", "seal", "merge"]),
            st.integers(0, 10_000),
        ),
        min_size=1, max_size=10,
    ),
)
@settings(max_examples=6, deadline=None)
def test_p7_mutable_interleavings_match_bruteforce(data_seed, backend, ops):
    nb, dim, k = 96, 8, 4
    rng0 = np.random.default_rng(data_seed)
    x = rng0.standard_normal((nb, dim)).astype(np.float32)
    # nprobe = nlist: IVF search is exact, so the brute force is the oracle
    cfg = HarmonyConfig(dim=dim, nlist=4, nprobe=4, topk=k, kmeans_iters=2)
    data = SegmentedIndex.build(x, cfg, device="cpu")
    srv = _server(data, backend)
    model = {i: x[i].copy() for i in range(nb)}
    deleted: set = set()
    next_id = nb
    for kind, s in ops:
        r = np.random.default_rng(s)
        if kind == "insert":
            v = r.standard_normal((1, dim)).astype(np.float32)
            srv.upsert([next_id], v)
            model[next_id] = v[0]
            deleted.discard(next_id)
            next_id += 1
        elif kind == "overwrite" and model:
            tid = sorted(model)[int(r.integers(0, len(model)))]
            v = r.standard_normal((1, dim)).astype(np.float32)
            srv.upsert([tid], v)
            model[tid] = v[0]
        elif kind == "delete" and model:
            tid = sorted(model)[int(r.integers(0, len(model)))]
            srv.delete([tid])
            del model[tid]
            deleted.add(tid)
        elif kind == "seal":
            data.compact_inline(merge_all=False)
        elif kind == "merge":
            data.compact_inline(merge_all=True)

    q = rng0.standard_normal((4, dim)).astype(np.float32)
    if model:
        probe_id = sorted(model)[-1]
        q[0] = model[probe_id]
    res = srv.search_batch(q, k=k)
    if not model:
        assert (res.ids == -1).all()
        return
    ids_m = np.array(sorted(model), np.int64)
    xs = np.stack([model[i] for i in ids_m])
    sc = exact_scores(xs, q, cfg.metric)
    order = np.argsort(sc, axis=1, kind="stable")[:, :k]
    want_s = np.full((4, k), np.inf, np.float32)
    kk = min(k, len(model))
    want_s[:, :kk] = np.take_along_axis(sc, order, axis=1)[:, :kk]
    finite = np.isfinite(want_s)
    np.testing.assert_allclose(res.scores[finite], want_s[finite], rtol=1e-3, atol=1e-3)
    assert not np.isin(res.ids, list(deleted) or [-999]).any()
    assert probe_id in res.ids[0]


@given(
    nq=st.integers(1, 6),
    k=st.integers(1, 8),
    widths=st.lists(st.integers(1, 12), min_size=1, max_size=5),
    huge_ids=st.booleans(),
    dup_scores=st.booleans(),
    seed=st.integers(0, 10_000),
)
@settings(**SETTINGS)
def test_p8_fused_merge_topk_equals_heap(nq, k, widths, huge_ids, dup_scores, seed):
    rng = np.random.default_rng(seed)
    i32max = np.iinfo(np.int32).max
    parts = []
    next_id = 0
    for w in widths:
        sc = rng.uniform(0, 10, size=(nq, w)).astype(np.float32)
        if dup_scores:
            sc = np.round(sc).astype(np.float32)
        ids = np.arange(next_id, next_id + w, dtype=np.int64)
        next_id += w
        parts.append((sc, np.broadcast_to(ids, sc.shape).copy()))
    if huge_ids:
        # the port carries columns through the kernel, so ids past int32
        # fold on it too, and must come back unwrapped
        parts[-1][1][:, -1] = i32max + 1
        if parts[-1][1].shape[1] > 1:
            parts[-1][1][:, -2] = i32max - 1
    fused_s, fused_i = merge_topk(parts, k, fused=True, device="cpu")
    host_s, host_i = merge_topk(parts, k, fused=False)
    np.testing.assert_allclose(fused_s, host_s, rtol=1e-6, atol=1e-7)
    assert (fused_i[~np.isfinite(fused_s)] == -1).all()
    assert np.abs(fused_i).max(initial=0) <= max(
        1, max(np.abs(np.asarray(ids)).max() for _, ids in parts))
    total = np.concatenate([s for s, _ in parts], axis=1)
    id_cat = np.concatenate([i for _, i in parts], axis=1)
    score_of = [dict(zip(id_cat[r].tolist(), total[r].tolist())) for r in range(nq)]
    for r in range(nq):
        for a, b, s in zip(fused_i[r], host_i[r], host_s[r]):
            if a != b:
                assert np.isfinite(s)
                np.testing.assert_allclose(score_of[r][int(a)], s, rtol=1e-6)
                np.testing.assert_allclose(score_of[r][int(b)], s, rtol=1e-6)
    f2 = merge_topk(parts, k, fused=True, device="cpu")
    h2 = merge_topk(parts, k, fused=False)
    assert np.array_equal(f2[1], fused_i) and np.array_equal(h2[1], host_i)


@given(
    data_seed=st.integers(0, 50),
    backend=st.sampled_from(["host", "spmd"]),
    ops=st.lists(
        st.tuples(
            st.sampled_from(["insert", "overwrite", "delete",
                             "checkpoint", "compact"]),
            st.integers(0, 10_000),
        ),
        min_size=1, max_size=8,
    ),
    crash=st.sampled_from([
        "clean", "torn_wal",
        "compactor.begin", "compactor.seal",
        "compactor.prepare", "compactor.commit",
        "checkpoint.write", "checkpoint.publish",
    ]),
)
@settings(max_examples=8, deadline=None)
def test_p9_crash_recovery_equals_acknowledged_oracle(data_seed, backend, ops, crash):
    import tempfile
    from pathlib import Path

    from repro_torch.checkpoint import (
        Checkpointer,
        WriteAheadLog,
        checkpoint_segmented_index,
        recover_segmented_index,
    )
    from repro_torch.runtime.faults import FaultSpec, InjectedFault, fault_scope
    from repro_torch.serve.compactor import Compactor

    nb, dim, k = 64, 8, 4
    rng0 = np.random.default_rng(data_seed)
    x = rng0.standard_normal((nb, dim)).astype(np.float32)
    # nprobe = nlist: search over the recovered plane is exact
    cfg = HarmonyConfig(dim=dim, nlist=4, nprobe=4, topk=k, kmeans_iters=2)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = SegmentedIndex.build(x, cfg, device="cpu")
        ckpt = Checkpointer(root / "ckpt", keep=3)
        wal = WriteAheadLog(root / "wal", sync=False)
        data.attach_wal(wal)
        # the base build predates the WAL: one durable point covers it
        checkpoint_segmented_index(ckpt, data, wal)

        model = {i: x[i].copy() for i in range(nb)}
        deleted: set = set()
        next_id = nb
        for kind, s in ops:
            r = np.random.default_rng(s)
            if kind == "insert":
                v = r.standard_normal((1, dim)).astype(np.float32)
                data.upsert(np.array([next_id], np.int64), v)
                model[next_id] = v[0]
                deleted.discard(next_id)
                next_id += 1
            elif kind == "overwrite" and model:
                tid = sorted(model)[int(r.integers(0, len(model)))]
                v = r.standard_normal((1, dim)).astype(np.float32)
                data.upsert(np.array([tid], np.int64), v)
                model[tid] = v[0]
            elif kind == "delete" and model:
                tid = sorted(model)[int(r.integers(0, len(model)))]
                data.delete(np.array([tid], np.int64))
                del model[tid]
                deleted.add(tid)
            elif kind == "checkpoint":
                checkpoint_segmented_index(ckpt, data, wal)
            elif kind == "compact":
                data.compact_inline(merge_all=bool(s % 2))

        # the crash: each branch leaves the disk as a process kill could,
        # then recovery reads the disk alone
        if crash == "torn_wal":
            # a power cut mid-append: a partial frame reaches the disk, the
            # write is never acknowledged, so the model must not see it
            v = rng0.standard_normal((1, dim)).astype(np.float32)
            with fault_scope(FaultSpec("wal.append", kind="torn")):
                with pytest.raises(InjectedFault):
                    data.upsert(np.array([next_id], np.int64), v)
        elif crash.startswith("compactor."):
            comp = Compactor(data, device="cpu")
            with fault_scope(FaultSpec(crash, kind="crash")):
                with pytest.raises(InjectedFault):
                    comp.run_once(merge_all=True)
        elif crash.startswith("checkpoint."):
            with fault_scope(FaultSpec(crash, kind="crash")):
                with pytest.raises(InjectedFault):
                    checkpoint_segmented_index(ckpt, data, wal)
        acked_seq = data.wal_seq
        wal.close()

        data2, wal2, report = recover_segmented_index(
            ckpt, root / "wal", cfg=cfg, sync=False, device="cpu"
        )
        try:
            # no acknowledged write lost, no phantom write
            assert data2.wal_seq == acked_seq
            if crash == "torn_wal":
                assert report["torn_tail"]
                assert not data2.has(next_id), "unacknowledged write resurrected"
            for i in model:
                assert data2.has(i), f"acknowledged id {i} lost"
            for i in deleted:
                if i not in model:
                    assert not data2.has(i), f"deleted id {i} resurfaced"
            srv = _server(data2, backend)
            q = rng0.standard_normal((4, dim)).astype(np.float32)
            probe_id = sorted(model)[-1]
            q[0] = model[probe_id]
            res = srv.search_batch(q, k=k)
            ids_m = np.array(sorted(model), np.int64)
            xs = np.stack([model[i] for i in ids_m])
            sc = exact_scores(xs, q, cfg.metric)
            order = np.argsort(sc, axis=1, kind="stable")[:, :k]
            want_s = np.full((4, k), np.inf, np.float32)
            kk = min(k, len(model))
            want_s[:, :kk] = np.take_along_axis(sc, order, axis=1)[:, :kk]
            finite = np.isfinite(want_s)
            np.testing.assert_allclose(res.scores[finite], want_s[finite],
                                       rtol=1e-3, atol=1e-3)
            assert probe_id in res.ids[0]
            assert not np.isin(res.ids, list(deleted) or [-999]).any()
        finally:
            wal2.close()


def _random_filter(r: np.random.Generator):
    """A small random expression tree over the "color" tag column and the
    "price" numeric column (the reference test's helper, on the port's
    filter types)."""

    def leaf():
        if r.integers(2):
            n_vals = int(r.integers(1, 4))
            vals = tuple(int(v) for v in r.integers(0, 5, size=n_vals))
            return TagIn("color", vals)
        lo, hi = sorted(float(v) for v in r.uniform(0.0, 1.0, size=2))
        return NumRange("price", lo, hi)

    flt = leaf()
    for _ in range(int(r.integers(0, 3))):
        flt = (flt & leaf()) if r.integers(2) else (flt | leaf())
    return flt


@given(
    data_seed=st.integers(0, 50),
    backend=st.sampled_from(["host", "spmd"]),
    precision=st.sampled_from(["fp32", "int8"]),
    flt_seed=st.integers(0, 10_000),
    n_delete=st.integers(0, 8),
    lifecycle=st.sampled_from(["delta", "seal", "merge"]),
)
@settings(max_examples=8, deadline=None)
def test_p10_filtered_search_matches_filtered_bruteforce(
        data_seed, backend, precision, flt_seed, n_delete, lifecycle):
    nb, dim, k = 96, 8, 4
    rng0 = np.random.default_rng(data_seed)
    x = rng0.standard_normal((nb, dim)).astype(np.float32)
    colors = rng0.integers(0, 5, size=nb)
    prices = rng0.uniform(0.0, 1.0, size=nb).astype(np.float32)
    # nprobe = nlist and a rerank_factor that keeps every probed candidate:
    # both tiers are exact, so the filtered brute force is the oracle
    cfg = HarmonyConfig(dim=dim, nlist=4, nprobe=4, topk=k, kmeans_iters=2,
                        rerank_factor=32)
    data = SegmentedIndex.build(x, cfg, device="cpu")
    srv = _server(data, backend)
    srv.upsert(np.arange(nb), x, meta={"color": colors, "price": prices})
    rng1 = np.random.default_rng(data_seed + 1)
    xe = rng1.standard_normal((4, dim)).astype(np.float32)
    bare_ids = np.arange(200, 204)
    srv.upsert(bare_ids, xe)
    if lifecycle == "seal":
        data.compact_inline(merge_all=False)
    elif lifecycle == "merge":
        data.compact_inline(merge_all=True)

    model = {int(i): x[i].copy() for i in range(nb)}
    meta = {int(i): (int(colors[i]), float(prices[i])) for i in range(nb)}
    for j, i in enumerate(bare_ids):
        model[int(i)] = xe[j]
    rng2 = np.random.default_rng(flt_seed)
    deleted = sorted(model)
    rng2.shuffle(deleted)
    deleted = deleted[:n_delete]
    if deleted:
        srv.delete(deleted)
        for i in deleted:
            del model[i]
    flt = _random_filter(rng2)

    ids_m = np.array(sorted(model), np.int64)
    tag_col = np.array([meta.get(int(i), (TAG_MISSING, np.nan))[0] for i in ids_m], np.int64)
    num_col = np.array([meta.get(int(i), (TAG_MISSING, np.nan))[1] for i in ids_m],
                       np.float32)
    allowed = flt.evaluate({"color": tag_col}, {"price": num_col}, len(ids_m))
    live = ids_m[allowed]

    q = rng0.standard_normal((4, dim)).astype(np.float32)
    probe_id = None
    if live.size:
        probe_id = int(live[-1])
        q[0] = model[probe_id]
    res = srv.search_batch(SearchRequest(vector=q, k=k, filter=flt, precision=precision))
    if not live.size:
        assert (res.ids == -1).all()
        return
    xs = np.stack([model[int(i)] for i in live])
    sc = exact_scores(xs, q, cfg.metric)
    order = np.argsort(sc, axis=1, kind="stable")[:, :k]
    want_s = np.full((4, k), np.inf, np.float32)
    kk = min(k, live.size)
    want_s[:, :kk] = np.take_along_axis(sc, order, axis=1)[:, :kk]
    finite = np.isfinite(want_s)
    np.testing.assert_allclose(res.scores[finite], want_s[finite], rtol=1e-3, atol=1e-3)
    assert (res.ids[~finite] == -1).all()
    got = res.ids[res.ids >= 0]
    assert np.isin(got, live).all()
    assert not np.isin(got, deleted or [-999]).any()
    assert not np.isin(got, bare_ids).any()
    assert probe_id in res.ids[0]
