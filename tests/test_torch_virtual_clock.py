"""The port's virtual-clock replay against the stored goldens
(``tests/goldens/serving_virtual_clock.json``, read, never written): the
eight scenarios and the cache-off case of
``tests/test_virtual_clock_goldens.py`` run through ``repro_torch`` on the
reference's index carried across (CPU). On the host backend, which the
reference's scenarios use, the digest equals the golden byte for byte; on
the spmd backend it equals it except for ``spmd_batches``."""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import build_ivf as r_build_ivf
from repro.data import make_dataset, make_queries
from repro_torch.config import HarmonyConfig
from repro_torch.core.index import ivf_from_arrays
from repro_torch.serve import (
    CacheConfig,
    HarmonyServer,
    ReplicaFleet,
    ReplicaSpec,
    SchedulerConfig,
    ServingScheduler,
)
from test_torch_segments import ivf_arrays
from test_virtual_clock_goldens import GOLDEN_PATH, _burst

# every key the reference's digest leaves out of the summary
_NOT_REPLAY = ("batches", "queries", "upserts", "deletes", "generation_swaps",
               "replica_failures", "breaker_opens", "breaker_closes",
               "health_probes", "retried_batches", "failed_batches",
               "failed_requests", "shutdown_leaks", "cache_hits_exact",
               "cache_hits_semantic", "cache_misses", "cache_invalidations",
               "coalesced", "expired_requests", "cold_batches",
               "bytes_streamed", "prefetch_hits", "placement_swaps")


@pytest.fixture(scope="module")
def fixture():
    """The goldens' fixture, with the reference's index carried across."""
    ds = make_dataset(nb=2000, dim=16, n_components=6, spread=0.6, seed=0)
    from repro.config import HarmonyConfig as RCfg

    rcfg = RCfg(dim=16, nlist=16, nprobe=4, topk=5, kmeans_iters=3)
    ref = r_build_ivf(ds.x, rcfg)
    cfg = HarmonyConfig(**dataclasses.asdict(rcfg))
    index = ivf_from_arrays(cfg, ivf_arrays(ref), device="cpu")
    q = make_queries(ds, nq=96, skew=0.3, noise=0.2, seed=1)
    qh = make_queries(ds, nq=64, skew=0.95, hot_fraction=0.06, noise=0.1,
                      seed=3)
    return cfg, index, q, qh


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_PATH.read_text())


def digest(sched, target) -> dict:
    """The reference's digest (``test_virtual_clock_goldens._digest``)
    over the port's classes."""
    stats = target.stats
    out = {
        "served": len(sched.done),
        "req_ids_sum": int(sum(r.req_id for r in sched.done)),
        "batch_ids": [r.batch_id for r in sorted(sched.done, key=lambda r: r.req_id)],
        "makespan_s": round(sched.makespan_s, 9),
        "queue_wait_sum_ms": round(float(np.sum(stats.queue_wait_ms)), 9),
        "latency_sum_ms": round(float(np.sum(stats.request_latency_ms)), 9),
        "summary": {k: (round(v, 9) if isinstance(v, float) else v)
                    for k, v in stats.summary().items() if k not in _NOT_REPLAY},
    }
    hedge = getattr(target, "_hedge", None) or getattr(sched, "_hedge", None)
    if hedge is not None:
        hs = hedge.stats
        out["hedge"] = {"dispatched": hs.dispatched, "hedged": hs.hedged,
                        "wasted": hs.wasted, "hedge_wins": hs.hedge_wins}
    if isinstance(target, ReplicaFleet):
        out["per_replica_batches"] = [r.batches for r in target.replicas]
        out["per_replica_queries"] = [r.queries for r in target.replicas]
        out["per_replica_busy_s"] = [round(r.busy_s, 9) for r in target.replicas]
        out["gini"] = round(target.load_balance_gini, 9)
    return out


def scenario(name, fixture, backend):
    """One scenario of the goldens through the port, every server and
    replica on ``backend``; returns (its digest, the servers)."""
    cfg, index, q, qh = fixture

    def server():
        return HarmonyServer(index, n_nodes=4, backend=backend, device="cpu")

    def spec(**kw):
        return ReplicaSpec(backend=backend, **kw)

    if name == "single_full":
        sched = ServingScheduler(server(), SchedulerConfig(max_batch=16), k=5,
                                 service_time_fn=lambda n: n * 1e-3)
        sched.run_trace(_burst(q, spacing=0.0))
    elif name == "single_deadline":
        sched = ServingScheduler(server(), SchedulerConfig(max_batch=32, max_wait_s=2e-3),
                                 k=5, service_time_fn=lambda n: 0.0)
        sched.run_trace([(0.01 * i, q[i]) for i in range(16)])
    elif name == "single_backpressure":
        sched = ServingScheduler(
            server(), SchedulerConfig(max_batch=4, queue_capacity=8, max_wait_s=1e-3),
            k=5, service_time_fn=lambda n: 1.0)
        sched.run_trace([(i * 1e-6, q[i % len(q)]) for i in range(64)])
    elif name == "single_hedged":
        sched = ServingScheduler(
            server(), SchedulerConfig(max_batch=8, hedge_deadline_s=0.01), k=5,
            service_time_fn=lambda n: n * 1e-4,
            latency_fn=lambda w, t: 0.5 if w == 0 else 1e-5)
        sched.run_trace(_burst(q[:32]))
    elif name == "single_skew_replan":
        sched = ServingScheduler(
            server(), SchedulerConfig(max_batch=8, replan_drift=0.15,
                                      min_batches_between_replans=2),
            k=5, service_time_fn=lambda n: n * 1e-4)
        sched.run_trace(_burst(q[:32], spacing=1e-4) + _burst(qh, spacing=1e-4, t0=0.01))
    elif name == "fleet_p2c_hetero":
        caps = [1.0, 1.0, 0.5, 0.5]
        fleet = ReplicaFleet(index, replicas=[spec(capacity=c) for c in caps], cfg=cfg,
                             routing="p2c", service_time_fn=lambda r, n: n * 1e-3 / caps[r],
                             seed=0, device="cpu")
        sched = ServingScheduler(fleet, SchedulerConfig(max_batch=8), k=5)
        sched.run_trace(_burst(qh))
    elif name == "fleet_hedged":
        fleet = ReplicaFleet(index, replicas=[spec() for _ in range(3)], cfg=cfg,
                             routing="least_loaded", service_time_fn=lambda r, n: n * 1e-4,
                             latency_fn=lambda r, t: 0.5 if r == 0 else 1e-5, seed=0,
                             device="cpu")
        sched = ServingScheduler(fleet, SchedulerConfig(max_batch=8, hedge_deadline_s=0.01),
                                 k=5)
        sched.run_trace(_burst(q))
    else:
        assert name == "fleet_churn"
        fleet = ReplicaFleet(index, replicas=[spec(), spec()], cfg=cfg,
                             routing="least_loaded", service_time_fn=lambda r, n: n * 1e-3,
                             seed=0, device="cpu")

        def churn(batch_idx, sched):
            if batch_idx == 2:
                fleet.fail_replica(1)
            elif batch_idx == 5:
                fleet.join_replica(spec())

        sched = ServingScheduler(fleet, SchedulerConfig(max_batch=8), k=5, on_batch=churn)
        sched.run_trace(_burst(q))
    target = sched.target
    servers = ([r.server for r in target.replicas] if isinstance(target, ReplicaFleet)
               else [target.server])
    return digest(sched, target), servers


SCENARIOS = ["single_full", "single_deadline", "single_backpressure", "single_hedged",
             "single_skew_replan", "fleet_p2c_hetero", "fleet_hedged", "fleet_churn"]


@pytest.fixture(scope="module")
def host_digests(fixture):
    return {name: scenario(name, fixture, "host")[0] for name in SCENARIOS}


def test_host_replay_writes_the_golden_file_byte_for_byte(host_digests):
    """All eight host digests, serialized as the goldens were written,
    are the stored file's bytes."""
    text = json.dumps(host_digests, indent=2, sort_keys=True) + "\n"
    assert text == GOLDEN_PATH.read_text()


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_replay_equals_golden(host_digests, golden, name):
    assert host_digests[name] == golden[name]


@pytest.mark.parametrize("name", SCENARIOS)
def test_spmd_replay_equals_golden_but_for_spmd_batches(fixture, golden, name):
    """Every batch goes through the spmd executors: the replay's counters
    are the golden's but for ``spmd_batches``, which counts them."""
    got, servers = scenario(name, fixture, "spmd")
    want = json.loads(json.dumps(golden[name]))
    assert want["summary"].pop("spmd_batches") == 0
    spmd = got["summary"].pop("spmd_batches")
    assert got == want
    assert all(s.stats.spmd_batches == s.stats.batches for s in servers)
    executed = sum(s.stats.spmd_batches for s in servers)
    assert executed > 0
    assert spmd == (0 if len(servers) > 1 or name.startswith("fleet") else executed)


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_cache_off_replay_is_byte_identical_to_golden(fixture, golden, backend):
    """A disabled cache, and an enabled exact-only cache on a repeat-free
    trace, leave ``single_full`` at the golden."""
    cfg, index, q, qh = fixture
    want = json.loads(json.dumps(golden["single_full"]))
    if backend == "spmd":
        want["summary"]["spmd_batches"] = 6          # 96 requests, max_batch 16
    for ccfg in (CacheConfig(enabled=False),
                 CacheConfig(enabled=True, semantic_threshold=0.0)):
        srv = HarmonyServer(index, n_nodes=4, backend=backend, device="cpu")
        sched = ServingScheduler(srv, SchedulerConfig(max_batch=16, cache=ccfg), k=5,
                                 service_time_fn=lambda n: n * 1e-3)
        sched.run_trace(_burst(q, spacing=0.0))
        assert json.dumps(digest(sched, sched.target), sort_keys=True) == \
            json.dumps(want, sort_keys=True), ccfg
