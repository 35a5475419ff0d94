"""The port's replica fleet against the JAX package's (CPU): mirrors of
``tests/test_fleet.py``, the fleet churn of ``tests/test_mutable_index.py``
and the replica cases of ``tests/test_faults.py``. Each scenario runs
through both packages on the same index (carried across) and trace, the
port's replicas on their default spmd backend and the reference's on its
default host backend: the answers are the reference's (scores at
rtol = atol = 1e-3, ids but for exact ties), and wherever the service
time is injected so are the placement, the Gini, the hedge and the
resilience counters."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.config
import repro.core
import repro.runtime.faults
import repro.serve
import repro_torch.config
import repro_torch.core
import repro_torch.runtime.faults
import repro_torch.serve
from repro.core import search_oracle
from repro.data import make_dataset, make_queries
from repro_torch.core.index import ivf_from_arrays
from test_executor import assert_matches_oracle
from test_torch_segments import ivf_arrays

REF = SimpleNamespace(serve=repro.serve, core=repro.core, faults=repro.runtime.faults,
                      cfg=repro.config.HarmonyConfig, kw={})
PORT = SimpleNamespace(serve=repro_torch.serve, core=repro_torch.core,
                       faults=repro_torch.runtime.faults,
                       cfg=repro_torch.config.HarmonyConfig, kw=dict(device="cpu"))


class Res:
    def __init__(self, results):
        self.ids = np.stack([r.ids for r in results])
        self.scores = np.stack([r.scores for r in results])


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=4000, dim=32, n_components=8, spread=0.6, seed=0)
    rcfg = repro.config.HarmonyConfig(dim=32, nlist=32, nprobe=6, topk=5, kmeans_iters=4)
    ref = repro.core.build_ivf(ds.x, rcfg)
    cfg = repro_torch.config.HarmonyConfig(**dataclasses.asdict(rcfg))
    index = ivf_from_arrays(cfg, ivf_arrays(ref), device="cpu")
    q = make_queries(ds, nq=96, skew=0.3, noise=0.2, seed=1)
    return ds, {id(REF): (rcfg, ref), id(PORT): (cfg, index)}, q


def burst_trace(q, spacing=1e-5):
    return [(i * spacing, q[i]) for i in range(len(q))]


def both(body, *args):
    """``body(pkg, *args)`` through the reference and the port; returns
    (reference value, port value)."""
    return body(REF, *args), body(PORT, *args)


def fleet_of(m, anns, **kw):
    _, idx, _ = anns
    cfg, index = idx[id(m)]
    return m.serve.ReplicaFleet(index, cfg=cfg, seed=0, **m.kw, **kw)


def placement(fleet):
    return ([r.batches for r in fleet.replicas], [r.queries for r in fleet.replicas],
            [round(r.busy_s, 9) for r in fleet.replicas], round(fleet.load_balance_gini, 9))


# -------------------------------------------------------------- exactness
def test_fleet_matches_oracle_and_the_reference(anns):
    ds, idx, q = anns

    def run(m):
        fleet = fleet_of(m, anns, replicas=3)
        sched = m.serve.ServingScheduler(fleet, m.serve.SchedulerConfig(max_batch=16), k=5)
        res = sched.run_trace(burst_trace(q))
        assert [r.req_id for r in res] == list(range(len(q)))
        served_by = [r.batches for r in fleet.replicas]
        assert sum(served_by) == len(q) // 16
        assert sum(1 for b in served_by if b > 0) >= 2
        assert fleet.stats.admitted == len(q) and fleet.stats.shed == 0
        return fleet, Res(res)

    (rf, rr), (tf, tr) = both(run)
    assert_matches_oracle(tr, rr)
    assert_matches_oracle(tr, search_oracle(idx[id(REF)][1], q, k=5))
    assert all(r.server.backend == "spmd" for r in tf.replicas)
    assert sum(r.server.stats.spmd_batches for r in tf.replicas) == len(q) // 16


# ------------------------------------------------- load balance under skew
def test_load_balance_gini_under_skew_beats_round_robin(anns):
    ds, idx, q = anns
    qh = make_queries(ds, nq=192, skew=0.9, hot_fraction=0.05, noise=0.1, seed=4)
    caps = [1.0, 1.0, 0.5, 0.5]

    def run(m, routing):
        fleet = fleet_of(m, anns, replicas=[m.serve.ReplicaSpec(capacity=c) for c in caps],
                         routing=routing, service_time_fn=lambda r, n: n * 1e-3 / caps[r])
        sched = m.serve.ServingScheduler(fleet, m.serve.SchedulerConfig(max_batch=8), k=5)
        res = sched.run_trace(burst_trace(qh))
        assert len(fleet.stats.request_latency_ms) == 192
        return placement(fleet), Res(res)

    for routing in ("round_robin", "p2c"):
        (rp, rr), (tp, tr) = both(run, routing)
        assert tp == rp
        assert_matches_oracle(tr, rr)
    rr_gini, p2c_gini = both(run, "round_robin")[1][0][3], both(run, "p2c")[1][0][3]
    assert p2c_gini < rr_gini and p2c_gini < 0.10


def test_fleet_scales_served_qps(anns):
    ds, idx, q = anns

    def qps(m, n_rep):
        fleet = fleet_of(m, anns, replicas=n_rep, service_time_fn=lambda r, n: n * 1e-3)
        sched = m.serve.ServingScheduler(fleet, m.serve.SchedulerConfig(max_batch=8), k=5)
        sched.run_trace(burst_trace(q))
        return sched.served_qps

    r4, t4 = both(qps, 4)
    r1, t1 = both(qps, 1)
    assert (t4, t1) == (r4, r1) and t4 >= 1.5 * t1


# ------------------------------------------------------ replica elasticity
def test_replica_fail_join_mid_trace_no_lost_requests(anns):
    ds, idx, q = anns

    def run(m):
        fleet = fleet_of(m, anns, replicas=2, routing="least_loaded",
                         service_time_fn=lambda r, n: n * 1e-3)

        def churn(batch_idx, sched):
            if batch_idx == 2:
                fleet.fail_replica(1)
            elif batch_idx == 5:
                fleet.join_replica(m.serve.ReplicaSpec())

        sched = m.serve.ServingScheduler(fleet, m.serve.SchedulerConfig(max_batch=8), k=5,
                                         on_batch=churn)
        res = sched.run_trace(burst_trace(q))
        assert len(res) == len(q) and fleet.stats.shed == 0
        assert len(fleet.replicas) == 3 and fleet.cluster.n_live == 2
        assert not fleet.cluster.live[1]
        assert fleet.replicas[1].batches <= 3 and fleet.replicas[2].batches > 0
        return placement(fleet), Res(res)

    (rp, rr), (tp, tr) = both(run)
    assert tp == rp
    assert_matches_oracle(tr, rr)


# -------------------------------------------------- cross-replica hedging
def test_cross_replica_hedge_fires_and_preserves_results(anns):
    ds, idx, q = anns

    def run(m, hedge_s):
        fleet = fleet_of(m, anns, replicas=3, routing="least_loaded",
                         service_time_fn=lambda r, n: n * 1e-4,
                         latency_fn=lambda r, t: 0.5 if r == 0 else 1e-5)
        sched = m.serve.ServingScheduler(
            fleet, m.serve.SchedulerConfig(max_batch=8, hedge_deadline_s=hedge_s), k=5)
        return fleet, sched.run_trace(burst_trace(q))

    (rf, rres), (tf, tres) = both(run, 0.01)
    hs = tf._hedge.stats
    assert hs.hedged >= 1 and hs.hedge_wins >= 1 and 0.0 < hs.win_rate <= 1.0
    assert dataclasses.asdict(hs) == dataclasses.asdict(rf._hedge.stats)
    assert tf.stats.hedged_batches == hs.hedged
    assert max(tf.stats.request_latency_ms) >= 10.0
    assert tf.stats.request_latency_ms == rf.stats.request_latency_ms
    assert placement(tf) == placement(rf)
    _, plain = run(PORT, 0.0)
    np.testing.assert_array_equal(Res(tres).ids, Res(plain).ids)
    assert_matches_oracle(Res(tres), Res(rres))


def test_hedge_threads_bind_the_fleet_device(anns, monkeypatch):
    """The wall-clock hedge's worker threads make the fleet's device
    current (a no-op on the CPU, recorded here)."""
    import repro_torch.runtime.straggler as straggler

    seen = []
    monkeypatch.setattr(straggler, "bind_device", lambda d: seen.append(d))
    hx = straggler.HedgingExecutor([lambda t: t + 1, lambda t: t + 2], deadline_s=5.0,
                                   device="cpu")
    assert hx.run_wall(1, 0, 1) == (2, 0, False)
    assert seen == ["cpu"]


# ------------------------------------------- heterogeneous host+spmd fleet
def test_heterogeneous_host_spmd_fleet_matches_oracle(anns):
    ds, idx, q = anns
    S = repro_torch.serve
    fleet = fleet_of(PORT, anns, replicas=[S.ReplicaSpec(backend="host"),
                                           S.ReplicaSpec(backend="spmd")],
                     routing="round_robin")
    sched = S.ServingScheduler(fleet, S.SchedulerConfig(max_batch=16), k=5)
    res = sched.run_trace(burst_trace(q[:64]))
    assert len(res) == 64
    assert fleet.replicas[0].batches > 0 and fleet.replicas[1].batches > 0
    assert fleet.replicas[0].server.stats.spmd_batches == 0
    assert fleet.replicas[1].server.stats.spmd_batches > 0
    assert_matches_oracle(Res(res), search_oracle(idx[id(REF)][1], q[:64], k=5))


def test_replica_spec_defaults_to_spmd():
    """By design the port's replicas serve on the executors, as its
    ``HarmonyServer`` does; the reference's default is the host engine."""
    assert repro_torch.serve.ReplicaSpec().backend == "spmd"
    assert repro.serve.ReplicaSpec().backend == "host"
    assert dataclasses.replace(repro_torch.serve.ReplicaSpec(), backend="host") == \
        repro_torch.serve.ReplicaSpec(backend="host")


# ------------------------------------------------- degenerate summaries
def test_shed_heavy_trace_summary_none_percentiles(anns):
    ds, idx, q = anns

    def run(m):
        fleet = fleet_of(m, anns, replicas=2, routing="least_loaded",
                         service_time_fn=lambda r, n: 1000.0)
        fleet.fail_replica(1)
        sched = m.serve.ServingScheduler(
            fleet, m.serve.SchedulerConfig(max_batch=4, queue_capacity=4, max_wait_s=1e-3),
            k=5)
        for i in range(64):
            sched.submit(m.core.SearchRequest(vector=q[i % len(q)]), i * 1e-6)
        s = fleet.summary()
        idle = [r for r in s["replicas"] if r["batches"] == 0]
        assert idle
        for r in idle:
            assert r["p50_service_ms"] is None and r["p99_service_ms"] is None
            assert r["server"]["p50_queue_wait_ms"] is None
        return {k: v for k, v in s.items()
                if k not in ("replicas", "spmd_batches")}, fleet.stats.shed

    (rs, rshed), (ts, tshed) = both(run)
    assert ts == rs and tshed == rshed > 0
    empty = repro_torch.serve.ServeStats().summary()
    for key in ("p50_queue_wait_ms", "p99_queue_wait_ms",
                "p50_request_latency_ms", "p99_request_latency_ms"):
        assert empty[key] is None


@pytest.mark.parametrize("x", [[1.0, 1.0, 1.0, 1.0], [], [0.0, 0.0], [0.0, 0.0, 0.0, 1.0],
                               [1.0, 1.0, 2.0, 2.0]])
def test_gini_helper(x):
    assert repro_torch.serve.gini(x) == repro.serve.gini(x)


# ------------------------------------------------------------- fleet churn
def test_fleet_fail_mutate_join_gets_current_generation():
    """A replica that joins after fail → upsert/delete → compact serves
    the current generation (the port's own compaction, nprobe = nlist)."""
    from test_mutable_index import DIM, apply_writes
    from test_torch_engine import brute_topk

    S = repro_torch.serve
    ds = make_dataset(nb=600, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = repro_torch.config.HarmonyConfig(dim=DIM, nlist=8, nprobe=8, topk=5,
                                           kmeans_iters=3)
    rng = np.random.default_rng(5)
    fleet = S.ReplicaFleet(repro_torch.core.build_ivf(ds.x, cfg, device="cpu"), replicas=2,
                           cfg=cfg, routing="least_loaded",
                           service_time_fn=lambda r, n: n * 1e-3, seed=0, device="cpu")
    comp = S.Compactor(fleet.data, fleet, S.CompactionConfig(delta_threshold=1),
                       device="cpu")
    q = ds.x[:48]

    def churn(batch_idx, sched):
        if batch_idx == 1:
            fleet.fail_replica(1)
            apply_writes(fleet, rng, ds)
            comp.run_once(merge_all=True, reason="churn")
        elif batch_idx == 3:
            fleet.join_replica(S.ReplicaSpec())

    sched = S.ServingScheduler(fleet, S.SchedulerConfig(max_batch=8), k=5, on_batch=churn)
    results = sched.run_trace([(i * 1e-5, repro_torch.core.SearchRequest(vector=q[i]))
                               for i in range(48)])
    assert len(results) == 48 and fleet.stats.shed == 0
    joiner = fleet.replicas[2].server
    assert joiner.generation == fleet.data.generation >= 1
    res = joiner.search_batch(q[:8], k=5)
    np.testing.assert_allclose(res.scores, brute_topk(fleet.data, q[:8], 5)[0],
                               rtol=1e-3, atol=1e-3)
    post = np.stack([r.scores for r in results[16:]])
    np.testing.assert_allclose(post, brute_topk(fleet.data, q, 5)[0][16:],
                               rtol=1e-3, atol=1e-3)


# -------------------------------------------------- replica crash + breaker
def _data(seed=0, nb=256):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nb, 8)).astype(np.float32)


def _faults_fleet(m, x, **kw):
    cfg = m.cfg(dim=8, nlist=4, nprobe=4, topk=3, kmeans_iters=2)
    if m is PORT:
        rcfg = REF.cfg(**dataclasses.asdict(cfg))
        index = ivf_from_arrays(cfg, ivf_arrays(repro.core.build_ivf(x, rcfg)), device="cpu")
    else:
        index = m.core.build_ivf(x, cfg)
    return m.serve.ReplicaFleet(index, cfg=cfg, seed=0, **m.kw, **kw)


def _trace(m, x, n=64, spacing=1e-3):
    return [(i * spacing, m.core.SearchRequest(vector=x[i])) for i in range(n)]


def test_replica_crash_served_by_retry_matches_reference():
    x = _data()

    def run(m):
        fleet = _faults_fleet(m, x, replicas=2, routing="round_robin",
                              service_time_fn=lambda r, n: n * 1e-3,
                              breaker_threshold=2, breaker_cooldown_s=0.005)
        sched = m.serve.ServingScheduler(fleet, m.serve.SchedulerConfig(max_batch=8), k=3)
        with m.faults.fault_scope(m.faults.FaultSpec(
                "replica.execute", at=1, count=4, where={"replica": 0})) as plan:
            res = sched.run_trace(_trace(m, x))
        assert len(res) == 64 and plan.fired >= 4
        s = fleet.stats
        assert s.replica_failures >= 4 and s.retried_batches >= 1
        assert s.breaker_opens >= 1 and s.breaker_closes >= 1 and s.failed_batches == 0
        return list(plan.log), fleet.stats.summary(), placement(fleet), Res(res)

    (rlog, rsum, rp, rres), (tlog, tsum, tp, tres) = both(run)
    assert tlog == rlog and tp == rp
    assert {k: v for k, v in tsum.items() if "ms" not in k} == \
        {k: v for k, v in rsum.items() if "ms" not in k}
    assert_matches_oracle(tres, rres)


def test_chaos_replay_is_deterministic_and_the_reference():
    x = _data()

    def run(m):
        fleet = _faults_fleet(m, x, replicas=3, routing="p2c",
                              service_time_fn=lambda r, n: n * 1e-3,
                              breaker_threshold=2, breaker_cooldown_s=0.01)
        sched = m.serve.ServingScheduler(fleet, m.serve.SchedulerConfig(max_batch=8), k=3)
        F = m.faults
        plan = F.FaultPlan(
            F.FaultSpec("replica.execute", at=2, count=3, where={"replica": 1}),
            F.FaultSpec("replica.execute", at=5, count=2, kind="delay", delay_s=0.02,
                        where={"replica": 0}),
            seed=11)
        with F.fault_scope(plan):
            res = sched.run_trace(_trace(m, x))
        return list(plan.log), fleet.stats.summary(), Res(res)

    log1, sum1, res1 = run(PORT)
    log2, sum2, res2 = run(PORT)
    rlog, rsum, rres = run(REF)
    assert log1 == log2 == rlog and sum1 == sum2 == rsum
    np.testing.assert_array_equal(res1.ids, res2.ids)
    assert_matches_oracle(res1, rres)


def test_breaker_open_ejects_then_probe_readmits_with_adoption():
    S, F = repro_torch.serve, repro_torch.runtime.faults
    x = _data()
    cfg = repro_torch.config.HarmonyConfig(dim=8, nlist=4, nprobe=4, topk=3, kmeans_iters=2)
    data = repro_torch.core.SegmentedIndex.build(x, cfg, device="cpu")
    fleet = S.ReplicaFleet(data, replicas=2, cfg=cfg, routing="least_loaded",
                           service_time_fn=lambda r, n: n * 1e-3, seed=0,
                           breaker_threshold=1, breaker_cooldown_s=0.5, device="cpu")
    sched = S.ServingScheduler(fleet, S.SchedulerConfig(max_batch=8), k=3)
    rng = np.random.default_rng(1)
    with F.fault_scope(F.FaultSpec("replica.execute", where={"replica": 0})):
        sched.run_trace(_trace(PORT, x, n=8, spacing=1e-4))
    rep0 = fleet.replicas[0]
    assert rep0.open_until is not None and fleet.stats.breaker_opens == 1
    fleet.upsert(np.array([999]), rng.standard_normal((1, 8)).astype(np.float32))
    data.compact_inline(merge_all=True)
    assert rep0.server.generation != data.generation
    ranked = fleet._rank_replicas(8, now=0.1, batch_id=0)
    assert ranked[0] == 1 and ranked[-1] == 0
    sched.advance(0.1)
    res2 = sched.run_trace([(0.7 + i * 1e-4, repro_torch.core.SearchRequest(vector=x[i]))
                            for i in range(8)])
    assert len(res2) == 16
    assert fleet.stats.health_probes >= 1 and fleet.stats.breaker_closes == 1
    assert rep0.open_until is None and rep0.server.generation == data.generation


def test_breaker_fail_open_when_all_replicas_tripped():
    x = _data()

    def run(m):
        fleet = _faults_fleet(m, x, replicas=2, routing="least_loaded",
                              service_time_fn=lambda r, n: n * 1e-3,
                              breaker_threshold=1, breaker_cooldown_s=100.0)
        sched = m.serve.ServingScheduler(
            fleet, m.serve.SchedulerConfig(max_batch=8, max_retries=2), k=3)
        with m.faults.fault_scope(m.faults.FaultSpec("replica.execute", at=1, count=4)):
            res = sched.run_trace(_trace(m, x, n=32))
        assert len(res) == 32 and fleet.stats.breaker_opens == 2
        served = [r for r in res if r.ids[0] != -1]
        assert len(served) >= 24 and fleet.next_free_s() >= 0.0
        return [r.ids[0] != -1 for r in res], fleet.stats.summary()["failed_batches"]

    r, t = both(run)
    assert t == r


def test_injected_straggler_delay_charges_the_virtual_clock():
    S, F = repro_torch.serve, repro_torch.runtime.faults
    x = _data()

    def build():
        fleet = _faults_fleet(PORT, x, replicas=2, routing="round_robin",
                              service_time_fn=lambda r, n: n * 1e-3)
        return fleet, S.ServingScheduler(fleet, S.SchedulerConfig(max_batch=8), k=3)

    fleet0, sched0 = build()
    base = sched0.run_trace(_trace(PORT, x, n=32))
    fleet1, sched1 = build()
    with F.fault_scope(F.FaultSpec("replica.execute", at=1, count=2, kind="delay",
                                   delay_s=0.5)) as plan:
        slow = sched1.run_trace(_trace(PORT, x, n=32))
    assert plan.fired == 2
    for a, b in zip(base, slow):
        np.testing.assert_array_equal(a.ids, b.ids)
    extra = sum(r.busy_s for r in fleet1.replicas) - sum(r.busy_s for r in fleet0.replicas)
    assert extra == pytest.approx(1.0, rel=1e-6)
    assert sched1.makespan_s > sched0.makespan_s


# ------------------------------------------------------- scheduler retries
def test_scheduler_retry_exhaustion_degrades_with_sentinels():
    x = _data()

    def run(m):
        fleet = _faults_fleet(m, x, replicas=1, service_time_fn=lambda r, n: n * 1e-3,
                              breaker_threshold=0)
        sched = m.serve.ServingScheduler(
            fleet, m.serve.SchedulerConfig(max_batch=8, max_retries=1), k=3)
        with m.faults.fault_scope(m.faults.FaultSpec("replica.execute", at=1, count=2)):
            res = sched.run_trace(_trace(m, x, n=24, spacing=1e-5))
        assert len(res) == 24
        s = fleet.stats
        assert s.failed_batches == 1 and s.failed_requests == 8 and s.retried_batches >= 1
        for r in res:
            if r.req_id < 8:
                assert (r.ids == -1).all() and np.isinf(r.scores).all()
            else:
                assert (r.ids != -1).any()
        return fleet.stats.summary()["retried_batches"], Res(res)

    (rn, rres), (tn, tres) = both(run)
    assert tn == rn
    assert_matches_oracle(tres, rres)


def test_scheduler_default_config_still_raises():
    S, F = repro_torch.serve, repro_torch.runtime.faults
    x = _data()
    fleet = _faults_fleet(PORT, x, replicas=1, service_time_fn=lambda r, n: n * 1e-3,
                          breaker_threshold=0)
    sched = S.ServingScheduler(fleet, S.SchedulerConfig(max_batch=8), k=3)
    with F.fault_scope(F.FaultSpec("replica.execute")):
        with pytest.raises(F.InjectedFault):
            sched.run_trace(_trace(PORT, x, n=8))


def test_device_fault_is_never_retried_or_degraded(monkeypatch):
    """A CUDA error from a replica propagates at once: no retry on the
    other replica (they share the card) and no sentinel degradation."""
    S = repro_torch.serve
    x = _data()
    fleet = _faults_fleet(PORT, x, replicas=2, service_time_fn=lambda r, n: n * 1e-3,
                          breaker_threshold=0)
    calls = []

    def faulted(self, *a, **kw):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(S.HarmonyServer, "search_batch", faulted)
    sched = S.ServingScheduler(fleet, S.SchedulerConfig(max_batch=8, max_retries=3), k=3)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sched.run_trace(_trace(PORT, x, n=8))
    assert len(calls) == 1
    assert fleet.stats.retried_batches == 0 and fleet.stats.failed_batches == 0
