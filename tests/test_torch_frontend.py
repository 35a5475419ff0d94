"""The port's live (wall-clock) front-end (CPU): mirrors of
``tests/test_frontend.py``, the front-end cases of ``tests/test_faults.py``
and the scheduler's prefetch lookahead of ``tests/test_tiered.py``. Stub
targets isolate the queue, triggers and lifecycle; the real-search cases
run the port's server and fleet on the reference's index (carried
across) and hold every answer against the reference's oracle (scores at
rtol = atol = 1e-3, ids but for exact ties). Every wall-clock case waits
with a timeout of its own and uses a sleep-dominated service model."""

import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest

import repro.config
import repro.core
import repro_torch.serve.frontend as t_frontend
from repro.core import search_oracle
from repro.data import make_dataset, make_queries
from repro_torch.config import HarmonyConfig
from repro_torch.core import SearchRequest, SegmentedIndex
from repro_torch.core.index import ivf_from_arrays
from repro_torch.runtime.faults import FaultSpec, InjectedFault, fault_scope
from repro_torch.serve import (
    DispatchTarget,
    HarmonyServer,
    MonotonicClock,
    ReplicaFleet,
    SchedulerConfig,
    ServeStats,
    ServingFrontend,
    ShedError,
    VirtualClock,
)
from repro_torch.serve.engine import LATENCY_SAMPLES
from test_executor import assert_matches_oracle
from test_torch_segments import ivf_arrays

WAIT = 60.0                          # seconds any one future may take


class StubResult:
    def __init__(self, n, k):
        self.ids = np.tile(np.arange(k, dtype=np.int64), (n, 1))
        self.scores = np.zeros((n, k), np.float32)


class StubTarget(DispatchTarget):
    """Executes instantly (or after a fixed wall sleep)."""

    def __init__(self, service_s: float = 0.0, parallel: int = 1, fail=None):
        self.stats = ServeStats()
        self.service_s = service_s
        self._parallel = parallel
        self.fail = fail
        self.executed = []

    def configure(self, cfg, k):
        pass

    def next_free_s(self):
        return 0.0

    def execute(self, queries, k, dispatch_s, batch_id):
        if self.fail is not None:
            raise self.fail
        if self.service_s:
            time.sleep(self.service_s)
        self.executed.append((batch_id, queries.shape[0]))
        return StubResult(queries.shape[0], k), dispatch_s + self.service_s

    default_max_batch = 8
    default_k = 5
    replans = 0
    nlist = 4

    @property
    def parallelism(self):
        return self._parallel


def reqs(n, dim=8):
    return [SearchRequest(vector=np.zeros(dim, np.float32)) for _ in range(n)]


def carried(nb, dim, nlist, nprobe, n_components, kmeans_iters, nq):
    ds = make_dataset(nb=nb, dim=dim, n_components=n_components, spread=0.6, seed=0)
    rcfg = repro.config.HarmonyConfig(dim=dim, nlist=nlist, nprobe=nprobe, topk=5,
                                      kmeans_iters=kmeans_iters)
    ref = repro.core.build_ivf(ds.x, rcfg)
    cfg = HarmonyConfig(**dataclasses.asdict(rcfg))
    q = make_queries(ds, nq=nq, skew=0.3, noise=0.2, seed=1)
    return ds, cfg, ref, ivf_from_arrays(cfg, ivf_arrays(ref), device="cpu"), q


@pytest.fixture(scope="module")
def anns():
    return carried(2000, 16, 16, 4, 6, 3, 64)


@pytest.fixture(scope="module")
def mini_anns():
    """Tiny corpus: real search compute stays negligible next to the
    injected wall service models."""
    return carried(512, 8, 8, 2, 4, 2, 64)


def by_req(results):
    class R:
        pass
    out = R()
    rs = sorted(results, key=lambda r: r.req_id)
    out.ids = np.stack([r.ids for r in rs])
    out.scores = np.stack([r.scores for r in rs])
    return out


# -------------------------------------------------- lifecycle
def test_submit_drain_shutdown_smoke():
    target = StubTarget()
    fe = ServingFrontend(target, SchedulerConfig(max_batch=4, max_wait_s=1e-3))
    futs = fe.submit_many(reqs(10))
    assert fe.drain(timeout=10.0)
    results = [f.result(timeout=WAIT) for f in futs]
    assert [r.req_id for r in results] == list(range(10))
    assert all(r.ids.shape == (5,) for r in results)
    assert fe.stats.offered == fe.stats.admitted == 10 and fe.stats.shed == 0
    assert sum(n for _, n in target.executed) == 10
    s = fe.summary()
    assert s["served"] == 10 and s["served_qps"] > 0
    assert s["full_batches"] + s["deadline_batches"] + s["capacity_batches"] \
        == len(target.executed)
    assert fe.shutdown() is True and fe.shutdown() is True
    assert not fe._dispatcher.is_alive() and fe.stats.shutdown_leaks == 0
    with pytest.raises(RuntimeError):
        fe.submit(reqs(1)[0])


def test_shutdown_reports_leaks_like_compactor_stop():
    target = StubTarget(service_s=0.3)
    fe = ServingFrontend(target, SchedulerConfig(max_batch=4, max_wait_s=1e-4))
    futs = fe.submit_many(reqs(4))
    deadline = time.monotonic() + 5.0
    while not fe._inflight and time.monotonic() < deadline:
        time.sleep(1e-3)
    assert fe.shutdown(timeout=0.01) is False
    assert len([f.result(timeout=WAIT) for f in futs]) == 4
    assert fe.shutdown() is True and fe.stats.shutdown_leaks == 0


def test_request_timeline_is_wall_ordered():
    target = StubTarget(service_s=0.01)
    with ServingFrontend(target, SchedulerConfig(max_batch=4, max_wait_s=1e-3)) as fe:
        results = [f.result(timeout=WAIT) for f in fe.submit_many(reqs(8))]
    for r in results:
        assert r.arrival_s <= r.dispatch_s <= r.done_s
        assert r.latency_s >= 0.01 - 1e-4
    assert len(fe.stats.request_latency_ms) == 8


def test_deadline_trigger_fires_small_batches():
    target = StubTarget()
    with ServingFrontend(target, SchedulerConfig(max_batch=64, max_wait_s=5e-3)) as fe:
        for r in reqs(4):
            fe.submit(r).result(timeout=WAIT)
    assert fe.stats.deadline_batches == 4 and fe.stats.full_batches == 0


def test_slow_target_sheds_by_backpressure():
    target = StubTarget(service_s=0.2)
    with ServingFrontend(
            target, SchedulerConfig(max_batch=4, queue_capacity=4, max_wait_s=1e-3)) as fe:
        futs = fe.submit_many(reqs(32))
        fe.drain(timeout=30.0)
        shed = [f for f in futs if isinstance(f.exception(timeout=WAIT), ShedError)]
        served = [f for f in futs if f.exception(timeout=WAIT) is None]
    assert fe.stats.offered == 32
    assert fe.stats.shed == len(shed) > 0
    assert fe.stats.admitted == len(served) == 32 - len(shed)


def test_asubmit_asyncio_roundtrip():
    target = StubTarget()

    async def drive(fe):
        return await asyncio.wait_for(
            asyncio.gather(*(fe.asubmit(r) for r in reqs(6))), timeout=WAIT)

    with ServingFrontend(target, SchedulerConfig(max_batch=4, max_wait_s=1e-3)) as fe:
        results = asyncio.run(drive(fe))
    assert sorted(r.req_id for r in results) == list(range(6))


def test_threads_make_the_target_device_current(monkeypatch):
    """The dispatcher and every pool thread bind the target's device
    before they run anything."""
    seen, mu = [], threading.Lock()

    def record(dev):
        with mu:
            seen.append((threading.current_thread().name, dev))

    monkeypatch.setattr(t_frontend, "bind_device", record)
    target = StubTarget(parallel=2)
    target.device = "cpu"
    with ServingFrontend(target, SchedulerConfig(max_batch=2, max_wait_s=1e-3)) as fe:
        [f.result(timeout=WAIT) for f in fe.submit_many(reqs(8))]
    names = {n for n, d in seen if d == "cpu"}
    assert "harmony-dispatch" in names
    assert any(n.startswith("harmony-serve") for n in names)


def test_device_fault_stops_the_frontend():
    """A CUDA error fails its batch and every queued request, and the
    front-end refuses later submissions, naming the fault as the cause."""
    fault = RuntimeError("CUDA error: an illegal memory access was encountered")
    target = StubTarget(fail=fault)
    fe = ServingFrontend(target, SchedulerConfig(max_batch=2, max_wait_s=1e-3,
                                                 max_retries=3))
    futs = fe.submit_many(reqs(6))
    errs = [f.exception(timeout=WAIT) for f in futs]
    assert errs[0] is fault and all(e is fault for e in errs if e is not None)
    assert fe.fault is fault and fe.stats.retried_batches == 0
    with pytest.raises(RuntimeError, match="shut down") as ei:
        fe.submit(reqs(1)[0])
    assert ei.value.__cause__ is fault
    assert fe.shutdown() is True and fe.stats.shutdown_leaks == 0


# -------------------------------------------------- fleet: overlap + safety
def test_fleet_overlaps_replica_execution_on_wall_clock(mini_anns):
    ds, cfg, ref, index, q = mini_anns
    per_q = 8e-3
    fleet = ReplicaFleet(index, replicas=4, cfg=cfg, routing="least_loaded",
                         service_time_fn=lambda r, n: n * per_q, seed=0, device="cpu")
    with ServingFrontend(fleet, SchedulerConfig(max_batch=8, max_wait_s=1e-3), k=5) as fe:
        assert fe.max_inflight == 4
        results = [f.result(timeout=WAIT) for f in
                   fe.submit_many([SearchRequest(vector=v) for v in q])]
    serial_s = len(q) * per_q
    assert fe.makespan_s < 0.6 * serial_s, (fe.makespan_s, serial_s)
    assert sum(r.batches for r in fleet.replicas) == len(q) // 8
    assert sum(1 for r in fleet.replicas if r.batches > 0) >= 2
    assert sum(r.server.stats.spmd_batches for r in fleet.replicas) >= len(q) // 8
    assert_matches_oracle(by_req(results), search_oracle(ref, q, k=5))


def test_fleet_ewma_accounting_safe_under_concurrent_dispatch(anns):
    ds, cfg, ref, index, q = anns
    fleet = ReplicaFleet(index, replicas=4, cfg=cfg, seed=0, device="cpu")
    per_q, n_threads, per_thread, n_q = 1e-3, 8, 50, 4

    def hammer(tid):
        rep = fleet.replicas[tid % 4]
        for _ in range(per_thread):
            fleet._record_service(rep, n_q, n_q * per_q,
                                  done_s=fleet._last_done_s + n_q * per_q)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    total = n_threads * per_thread
    assert sum(r.batches for r in fleet.replicas) == total
    assert sum(r.queries for r in fleet.replicas) == total * n_q
    for rep in fleet.replicas:
        assert rep.batches == (n_threads // 4) * per_thread
        assert rep.ewma_per_q_s == pytest.approx(per_q)
        assert rep.busy_s == pytest.approx(rep.batches * n_q * per_q)
    assert fleet._fleet_ewma_norm_per_q == pytest.approx(per_q)


def test_fleet_wall_hedge_fires_and_preserves_results(mini_anns):
    ds, cfg, ref, index, q = mini_anns
    fleet = ReplicaFleet(index, replicas=3, cfg=cfg, routing="least_loaded",
                         service_time_fn=lambda r, n: 0.4 if r == 0 else 1e-3, seed=0,
                         device="cpu")
    with ServingFrontend(
            fleet, SchedulerConfig(max_batch=8, max_wait_s=1e-3, hedge_deadline_s=0.05),
            k=5) as fe:
        results = [f.result(timeout=WAIT) for f in
                   fe.submit_many([SearchRequest(vector=v) for v in q[:32]])]
    hs = fleet._hedge.stats
    assert hs.hedged >= 1 and hs.hedge_wins >= 1
    assert fleet.stats.hedged_batches == hs.hedged
    assert_matches_oracle(by_req(results), search_oracle(ref, q[:32], k=5))


# -------------------------------------------------- single real server
@pytest.mark.parametrize("backend", ["spmd", "host"])
def test_single_server_frontend_matches_oracle(anns, backend):
    ds, cfg, ref, index, q = anns
    srv = HarmonyServer(index, n_nodes=4, backend=backend, device="cpu")
    with ServingFrontend(srv, SchedulerConfig(max_batch=16, max_wait_s=1e-3), k=5) as fe:
        results = [f.result(timeout=WAIT) for f in
                   fe.submit_many([SearchRequest(vector=v) for v in q])]
    assert fe.stats.admitted == len(q) and fe.stats.shutdown_leaks == 0
    assert srv.stats.spmd_batches == (srv.stats.batches if backend == "spmd" else 0)
    assert_matches_oracle(by_req(results), search_oracle(ref, q, k=5))


def test_clocks():
    v = VirtualClock()
    assert v.now() == 0.0
    v.advance_to(2.0)
    v.advance_to(1.0)
    assert v.now() == 2.0
    v.sleep(10.0)
    assert v.now() == 2.0
    m = MonotonicClock()
    t0 = m.now()
    m.sleep(0.005)
    assert m.now() - t0 >= 0.004
    m.advance_to(1e9)
    assert m.now() < 1e6


def test_latency_samples_keep_the_newest():
    st = ServeStats()
    n = LATENCY_SAMPLES + 3
    for i in range(n):
        st.queue_wait_ms.append(float(i))
    assert len(st.queue_wait_ms) == LATENCY_SAMPLES
    assert st.queue_wait_ms[0] == 3.0 and st.queue_wait_ms[-1] == n - 1
    assert st.summary()["p50_queue_wait_ms"] == float(np.percentile(np.arange(3, n), 50))
    st.request_latency_ms.extend([1.0, 2.0])
    assert st.request_latency_ms == [1.0, 2.0] and [1.0, 2.0] == st.request_latency_ms
    assert st.request_latency_ms != [2.0, 1.0] and not st.request_latency_ms != [1.0, 2.0]


# ------------------------------------------------------ faults (wall clock)
def _fault_fleet():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 8)).astype(np.float32)
    cfg = HarmonyConfig(dim=8, nlist=4, nprobe=4, topk=3, kmeans_iters=2)
    rcfg = repro.config.HarmonyConfig(**dataclasses.asdict(cfg))
    ref = repro.core.build_ivf(x, rcfg)
    index = ivf_from_arrays(cfg, ivf_arrays(ref), device="cpu")
    fleet = ReplicaFleet(index, replicas=1, cfg=cfg, seed=0, breaker_threshold=0,
                         device="cpu")
    return x, ref, fleet


def test_frontend_retries_idempotent_reads_under_faults():
    x, ref, fleet = _fault_fleet()
    cfg = SchedulerConfig(max_batch=4, max_wait_s=1e-3, max_retries=3,
                          retry_backoff_s=1e-4)
    with fault_scope(FaultSpec("replica.execute", at=1, count=1)) as plan:
        with ServingFrontend(fleet, cfg, k=3) as fe:
            futs = fe.submit_many([SearchRequest(vector=v) for v in x[:8]])
            results = [f.result(timeout=WAIT) for f in futs]
    assert len(results) == 8 and plan.fired == 1
    assert fleet.stats.retried_batches >= 1 and fleet.stats.failed_batches == 0
    assert_matches_oracle(by_req(results), search_oracle(ref, x[:8], k=3))


def test_frontend_failed_batch_fails_futures_but_keeps_serving():
    x, ref, fleet = _fault_fleet()
    cfg = SchedulerConfig(max_batch=4, max_wait_s=1e-3)
    with ServingFrontend(fleet, cfg, k=3) as fe:
        with fault_scope(FaultSpec("replica.execute", at=1, count=1)):
            doomed = fe.submit_many([SearchRequest(vector=v) for v in x[:4]])
            errs = []
            for f in doomed:
                try:
                    f.result(timeout=WAIT)
                except InjectedFault as e:
                    errs.append(e)
        assert len(errs) >= 1
        ok = [f.result(timeout=WAIT)
              for f in fe.submit_many([SearchRequest(vector=v) for v in x[4:8]])]
        assert len(ok) == 4
    assert fleet.stats.failed_batches == 1
    assert fleet.stats.failed_requests == len(errs)


# ------------------------------------------------------ prefetch lookahead
def test_prefetch_hits_and_lookahead():
    """Host-tier segments: an explicit prefetch is hit by the next batch,
    and ``serve`` through the scheduler prefetches the queued next batch
    on its own (the tiered cell's lookahead)."""
    rng = np.random.default_rng(0)
    cfg = HarmonyConfig(dim=16, nlist=8, nprobe=4, topk=5, kmeans_iters=3)
    x = rng.standard_normal((576, 16)).astype(np.float32)
    data = SegmentedIndex.build(x[:384], cfg, device="cpu")
    data.upsert(np.arange(384, 576), x[384:])
    data.compact_inline()
    data.set_tiers({s.seg_id: "host" for s in data.segments})
    srv = HarmonyServer(data, n_nodes=2, backend="spmd", device="cpu")
    picks = np.random.default_rng(3).integers(0, len(x), 8)
    q = (x[picks] + 0.05 * np.random.default_rng(4).standard_normal((8, 16))
         ).astype(np.float32)
    srv.prefetch_batch(q)
    res = srv.search_batch(q)
    assert res.stats["prefetch_hits"] == data.n_segments
    assert srv.stats.prefetch_hits == data.n_segments
    hits0 = srv.stats.prefetch_hits
    srv.serve([q[i: i + 2] for i in range(0, 8, 2)],
              sched=SchedulerConfig(backend="spmd", max_batch=2))
    assert srv.stats.prefetch_hits > hits0
