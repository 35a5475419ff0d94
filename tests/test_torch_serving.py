"""The port's admission-controlled scheduler and ``HarmonyServer.serve``
against the JAX package's on the same index (carried across) and the
same traces (CPU): mirrors of ``tests/test_serving.py`` and of the
zero-downtime swap of ``tests/test_mutable_index.py``. Every scheduled
result equals the reference's (scores at rtol = atol = 1e-3, ids but for
exact ties), and the admission counters equal the reference's wherever
the service time is injected."""

import dataclasses

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import build_ivf as r_build_ivf
from repro.core import search_oracle
from repro.core.types import SearchRequest as RRequest
from repro.data import make_dataset, make_queries
from repro.serve import HarmonyServer as RServer
from repro.serve import SchedulerConfig as RSchedCfg
from repro.serve import ServingScheduler as RScheduler
from repro_torch.config import HarmonyConfig
from repro_torch.core import SearchRequest, SegmentedIndex
from repro_torch.core.index import ivf_from_arrays
from repro_torch.serve import (
    CompactionConfig,
    Compactor,
    HarmonyServer,
    SchedulerConfig,
    ServingScheduler,
)
from test_executor import assert_matches_oracle
from test_torch_segments import ivf_arrays

BACKENDS = ["spmd", "host"]
# admission-side counters: equal to the reference's on the same trace
ADMISSION = ("offered", "admitted", "shed", "full_batches", "deadline_batches",
             "capacity_batches", "skew_replans", "hedged_batches", "replans",
             "expired_requests")


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=4000, dim=32, n_components=8, spread=0.6, seed=0)
    rcfg = RCfg(dim=32, nlist=32, nprobe=6, topk=5, kmeans_iters=4)
    ref = r_build_ivf(ds.x, rcfg)
    cfg = HarmonyConfig(**dataclasses.asdict(rcfg))
    index = ivf_from_arrays(cfg, ivf_arrays(ref), device="cpu")
    q = make_queries(ds, nq=64, skew=0.3, noise=0.2, seed=1)
    return ds, ref, index, q


class Res:
    def __init__(self, ids, scores):
        self.ids, self.scores = ids, scores


def stacked(results):
    return Res(np.stack([r.ids for r in results]), np.stack([r.scores for r in results]))


def twin(anns, backend, trace, k=5, on_batch=None, n_nodes=4, **kw):
    """The same trace through the reference's scheduler (host server, its
    default) and the port's (a ``backend`` server). ``kw`` go to both
    ``SchedulerConfig`` s, except ``service_time_fn`` / ``latency_fn``."""
    ds, ref, index, q = anns
    fns = {n: kw.pop(n) for n in ("service_time_fn", "latency_fn") if n in kw}
    r_srv = RServer(ref, n_nodes=n_nodes)
    t_srv = HarmonyServer(index, n_nodes=n_nodes, backend=backend, device="cpu")
    r = RScheduler(r_srv, RSchedCfg(**kw), k=k, on_batch=on_batch, **fns)
    t = ServingScheduler(t_srv, SchedulerConfig(**kw), k=k, on_batch=on_batch, **fns)
    rr, tr = r.run_trace(trace), t.run_trace(trace)
    assert [x.req_id for x in tr] == [x.req_id for x in rr]
    if rr:
        assert_matches_oracle(stacked(tr), stacked(rr))
    return r, t, rr, tr


def same_admission(r, t):
    rs, ts = r.stats.summary(), t.stats.summary()
    assert {k: ts[k] for k in ADMISSION} == {k: rs[k] for k in ADMISSION}


# ------------------------------------------------------------- exactness
@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduled_results_bitwise_equal_synchronous(anns, backend):
    """Scheduled serving with the same batch composition is bitwise the
    synchronous drain loop of the same server, and the reference's."""
    ds, ref, index, q = anns
    B = 16
    r, t, rr, tr = twin(anns, backend, [(0.0, q[i]) for i in range(len(q))],
                        max_batch=B)
    assert [x.req_id for x in tr] == list(range(len(q)))
    sync = HarmonyServer(index, n_nodes=4, backend=backend, device="cpu")
    want = [sync.search_batch(q[lo:lo + B], 5) for lo in range(0, len(q), B)]
    assert np.array_equal(stacked(tr).scores, np.concatenate([w.scores for w in want]))
    assert np.array_equal(stacked(tr).ids, np.concatenate([w.ids for w in want]))
    assert t.stats.full_batches == len(q) // B
    assert t.stats.deadline_batches == 0 and t.stats.shed == 0
    same_admission(r, t)
    assert t.server.stats.spmd_batches == (4 if backend == "spmd" else 0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_stream_is_scheduled_and_aligned(anns, backend):
    """``serve`` returns one result per input batch, aligned with the
    stream, equal to the reference's ``serve`` and to its oracle."""
    ds, ref, index, q = anns
    stream = [q[0:16], q[16:48], q[48:64]]
    srv = HarmonyServer(index, n_nodes=4, backend=backend, device="cpu")
    outs = srv.serve(stream, k=5)
    r_outs = RServer(ref, n_nodes=4).serve(stream, k=5)
    assert [o.ids.shape[0] for o in outs] == [16, 32, 16]
    for o, ro in zip(outs, r_outs):
        assert o.stats["scheduled"] and o.ids.dtype == np.int64
        assert_matches_oracle(o, ro)
    oracle = search_oracle(ref, q, k=5)
    assert_matches_oracle(Res(np.concatenate([o.ids for o in outs]),
                              np.concatenate([o.scores for o in outs])), oracle)
    assert srv.stats.admitted == 64 and srv.stats.shed == 0


def test_serve_with_arrivals_requests_and_shedding(anns):
    """``serve`` over per-row arrivals, a ``SearchRequest`` entry with its
    own k, and a bounded queue: the reference's rows, its shed rows kept
    at -1 / +inf, and its counters. Whatever the measured service time,
    the same-instant burst fills the queue (16 served, 24 shed) and the
    entry arriving long after the drain serves 16 of its 24 rows."""
    ds, ref, index, q = anns
    stream = [q[0:16], q[16:40], q[40:64]]
    arrivals = [0.0, [0.0] * 24, 1000.0]
    sched = dict(max_batch=8, queue_capacity=8, max_wait_s=1e-3)
    srv = HarmonyServer(index, n_nodes=4, device="cpu")
    r_srv = RServer(ref, n_nodes=4)
    outs = srv.serve([stream[0], stream[1], SearchRequest(vector=stream[2], k=7)],
                     k=5, sched=SchedulerConfig(**sched), arrivals=arrivals)
    r_outs = r_srv.serve([stream[0], stream[1], RRequest(vector=stream[2], k=7)],
                         k=5, sched=RSchedCfg(**sched), arrivals=arrivals)
    assert [o.ids.shape for o in outs] == [(16, 5), (24, 5), (24, 7)]
    assert [int((o.ids[:, 0] == -1).sum()) for o in outs] == [0, 24, 8]
    for o, ro in zip(outs, r_outs):
        shed = ro.ids[:, 0] == -1
        assert np.array_equal(o.ids[:, 0] == -1, shed)
        assert (o.ids[shed] == -1).all() and np.isinf(o.scores[shed]).all()
        assert_matches_oracle(o, ro)
    assert srv.stats.shed == r_srv.stats.shed > 0
    assert srv.stats.admitted == r_srv.stats.admitted
    with pytest.raises(ValueError, match="arrivals exhausted"):
        srv.serve(stream, k=5, arrivals=[0.0])


# ------------------------------------------------------ triggers and shedding
@pytest.mark.parametrize("backend", BACKENDS)
def test_deadline_triggers_batches_under_slow_arrivals(anns, backend):
    ds, ref, index, q = anns
    n = 8
    r, t, rr, tr = twin(anns, backend, [(0.010 * i, q[i]) for i in range(n)],
                        max_batch=32, max_wait_s=0.002, service_time_fn=lambda n: 0.0)
    assert len(tr) == n
    assert t.stats.deadline_batches == n and t.stats.full_batches == 0
    assert all(0.0 <= w <= 2.0 + 1e-6 for w in t.stats.queue_wait_ms)
    assert t.stats.queue_wait_ms == r.stats.queue_wait_ms
    assert_matches_oracle(stacked(tr), search_oracle(ref, q[:n], k=5))
    same_admission(r, t)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backpressure_sheds_and_counts(anns, backend):
    ds, ref, index, q = anns
    n = 64
    r, t, rr, tr = twin(anns, backend, [(i * 1e-6, q[i % len(q)]) for i in range(n)],
                        max_batch=4, queue_capacity=8, max_wait_s=0.001,
                        service_time_fn=lambda n: 1.0)
    st = t.stats
    assert st.offered == n and st.admitted == 12 and st.shed == n - 12
    assert len(tr) == st.admitted == len({x.req_id for x in tr})
    same_admission(r, t)
    assert st.request_latency_ms == r.stats.request_latency_ms


@pytest.mark.parametrize("backend", BACKENDS)
def test_capacity_fire_drains_bounded_queue_early(anns, backend):
    ds, ref, index, q = anns
    r, t, rr, tr = twin(anns, backend, [(i * 1e-4, q[i]) for i in range(8)],
                        max_batch=8, queue_capacity=2, max_wait_s=1.0,
                        service_time_fn=lambda n: 0.0)
    st = t.stats
    assert len(tr) == 8 and st.shed == 0
    assert st.capacity_batches == 4
    assert st.full_batches == 0 and st.deadline_batches == 0
    assert_matches_oracle(stacked(tr), search_oracle(ref, q[:8], k=5))
    same_admission(r, t)


# ------------------------------------------------------ elastic and skew
@pytest.mark.parametrize("backend", BACKENDS)
def test_fail_node_mid_stream_preserves_results(anns, backend):
    ds, ref, index, q = anns

    def killer(batch_idx, sched):
        if batch_idx == 1:
            sched.server.fail_node(1)

    r, t, rr, tr = twin(anns, backend, [(0.0, q[i]) for i in range(len(q))],
                        on_batch=killer, max_batch=16)
    assert t.server.cluster.n_live == 3 and t.server.stats.replans >= 1
    assert t.server.plan.v_shards * t.server.plan.d_blocks == \
        r.server.plan.v_shards * r.server.plan.d_blocks
    assert_matches_oracle(stacked(tr), search_oracle(ref, q, k=5))


@pytest.mark.parametrize("backend", BACKENDS)
def test_skew_drift_triggers_replan(anns, backend):
    """Uniform then hot traffic drifts the window's hot mass past the
    threshold: the port re-plans where the reference does, results exact."""
    ds, ref, index, q = anns
    qu = make_queries(ds, nq=32, skew=0.0, noise=0.2, seed=2)
    qh = make_queries(ds, nq=64, skew=0.95, hot_fraction=0.04, noise=0.1, seed=3)
    trace = [(i * 1e-4, qu[i]) for i in range(32)]
    trace += [(0.01 + i * 1e-4, qh[i]) for i in range(64)]
    r, t, rr, tr = twin(anns, backend, trace, max_batch=8, replan_drift=0.15,
                        min_batches_between_replans=2, service_time_fn=lambda n: 1e-4)
    assert len(tr) == 96 and t.stats.skew_replans >= 1
    same_admission(r, t)
    assert_matches_oracle(stacked(tr), search_oracle(ref, np.concatenate([qu, qh]), k=5))


@pytest.mark.parametrize("backend", BACKENDS)
def test_hedged_dispatch_fires_and_preserves_results(anns, backend):
    ds, ref, index, q = anns
    r, t, rr, tr = twin(anns, backend, [(0.0, q[i]) for i in range(32)],
                        max_batch=8, hedge_deadline_s=0.01,
                        latency_fn=lambda w, t: 0.5 if w == 0 else 1e-5)
    assert t.stats.hedged_batches >= 1 and t._hedge.stats.hedged >= 1
    assert dataclasses.asdict(t._hedge.stats) == dataclasses.asdict(r._hedge.stats)
    assert_matches_oracle(stacked(tr), search_oracle(ref, q[:32], k=5))


# ------------------------------------------------------------- plumbing
def test_summary_none_percentiles_with_zero_completions(anns):
    ds, ref, index, q = anns
    srv = HarmonyServer(index, n_nodes=4, device="cpu")
    sched = ServingScheduler(
        srv, SchedulerConfig(max_batch=64, max_wait_s=10.0, queue_capacity=8), k=5)
    for i in range(4):
        sched.submit(SearchRequest(vector=q[i]), 0.0)
    s = srv.stats.summary()
    assert srv.stats.admitted == 4 and srv.stats.batches == 0
    for key in ("p50_queue_wait_ms", "p99_queue_wait_ms",
                "p50_request_latency_ms", "p99_request_latency_ms"):
        assert s[key] is None
    assert len(sched.flush()) == 4
    assert srv.stats.summary()["p50_queue_wait_ms"] is not None


def test_stats_summary_and_percentiles(anns):
    ds, ref, index, q = anns
    srv = HarmonyServer(index, n_nodes=4, device="cpu")
    sched = ServingScheduler(srv, SchedulerConfig(max_batch=16), k=5)
    sched.run_trace([(0.0, SearchRequest(vector=q[i])) for i in range(32)])
    s = srv.stats.summary()
    assert set(s) == set(RServer(anns[1], n_nodes=4).stats.summary())
    assert s["admitted"] == 32 and s["spmd_batches"] == 2
    assert srv.stats.queue_wait_pct(50) <= srv.stats.queue_wait_pct(99) + 1e-9
    assert sched.served_qps > 0


def test_bare_array_submission_warns_as_the_reference():
    srv = HarmonyServer(SegmentedIndex(HarmonyConfig(dim=4, nlist=2), (), device="cpu"),
                        n_nodes=1, device="cpu")
    sched = ServingScheduler(srv, SchedulerConfig(max_batch=1), k=1)
    with pytest.warns(DeprecationWarning, match="repro_torch.core.SearchRequest"):
        sched.submit(np.zeros(4, np.float32), 0.0)
    assert sched.flush()[0].ids.tolist() == [-1]


# --------------------------------------------- zero-downtime swap (mutable)
def test_zero_downtime_swap_in_virtual_clock_harness():
    """Queries are served through a mid-trace write burst and a merge of
    everything (the port's own compaction, nprobe = nlist): nothing shed,
    each batch exact for the data state it was dispatched against, as in
    the reference's harness."""
    from test_mutable_index import DIM, apply_writes
    from test_torch_engine import brute_topk

    ds = make_dataset(nb=600, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = HarmonyConfig(dim=DIM, nlist=8, nprobe=8, topk=5, kmeans_iters=3)
    rng = np.random.default_rng(3)
    data = SegmentedIndex.build(ds.x, cfg, device="cpu")
    srv = HarmonyServer(data, n_nodes=4, device="cpu")
    comp = Compactor(data, srv, CompactionConfig(delta_threshold=1), device="cpu")
    q = (ds.x[:64] + 0.05 * rng.standard_normal((64, DIM))).astype(np.float32)
    pre = brute_topk(data, q, 5)
    post = {}

    def hook(batch_idx, sched):
        if batch_idx == 3:
            apply_writes(srv, rng, ds)
            ev = comp.run_once(merge_all=True, reason="mid-trace")
            assert ev["segments_after"] == 1
            post["truth"] = brute_topk(data, q, 5)

    sched = ServingScheduler(srv, SchedulerConfig(max_batch=8, queue_capacity=0), k=5,
                             on_batch=hook)
    results = sched.run_trace([(i * 1e-5, SearchRequest(vector=q[i])) for i in range(64)])
    assert len(results) == 64 and srv.stats.shed == 0
    assert srv.stats.generation_swaps >= 1 and srv.stats.spmd_batches == 8
    got = np.stack([r.scores for r in results])
    np.testing.assert_allclose(got[:32], pre[0][:32], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[32:], post["truth"][0][32:], rtol=1e-3, atol=1e-3)
