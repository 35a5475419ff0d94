"""The port's semantic query cache and request coalescing against the JAX
package's (CPU): mirrors of ``tests/test_cache.py``. Each cache-unit and
scheduler case runs through both packages on the same inputs and must
give the same tiers, answers and counters; the front-end cases run
through the port. Invariant P11 runs on the fixed grid through the port,
with its body (``tests/cache_invariants.py``, which imports the
reference) copied below, and its tier sequence and counters equal the
reference's on the same interleaving."""

from types import SimpleNamespace

import numpy as np
import pytest

import repro.config
import repro.core
import repro.serve
import repro.serve.executor
import repro_torch.config
import repro_torch.core
import repro_torch.serve
from cache_invariants import retry_flaky

REF = SimpleNamespace(cfg=repro.config.HarmonyConfig, core=repro.core,
                      serve=repro.serve, ExecutorConfig=repro.serve.executor.ExecutorConfig,
                      kw={}, exec_kw=dict(use_pallas=False))
PORT = SimpleNamespace(cfg=repro_torch.config.HarmonyConfig, core=repro_torch.core,
                       serve=repro_torch.serve,
                       ExecutorConfig=repro_torch.serve.ExecutorConfig,
                       kw=dict(device="cpu"), exec_kw={})


def both(body, *args):
    """Run ``body(pkg, *args)`` for the reference and the port; the port's
    returned value must equal the reference's."""
    want = body(REF, *args)
    got = body(PORT, *args)
    assert got == want
    return got


def _plane(m, nb=256, dim=8, seed=0, **over):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, dim)).astype(np.float32)
    cfg = m.cfg(dim=dim, nlist=4, nprobe=4, topk=3, kmeans_iters=2, **over)
    return x, cfg, m.core.SegmentedIndex.build(x, cfg, **m.kw)


def counters(stats):
    s = stats.summary()
    return {k: s[k] for k in ("offered", "admitted", "shed", "cache_hits_exact",
                              "cache_hits_semantic", "cache_misses",
                              "cache_invalidations", "coalesced", "expired_requests",
                              "queries", "full_batches", "deadline_batches",
                              "capacity_batches")}


# --------------------------------------------------------------- cache unit
def _ttl(m):
    c = m.serve.QueryCache(m.serve.CacheConfig(enabled=True, exact_ttl_s=10.0), **m.kw)
    q = np.arange(4, dtype=np.float32)
    opts = (None, None, None)
    c.insert(q, 3, opts, np.array([1, 2, 3]), np.array([0.1, 0.2, 0.3]), now_s=0.0)
    out = [c.lookup(q, 3, opts, now_s=9.9).tier,
           c.lookup(q, 3, opts, now_s=10.1), c.stats.cache_invalidations, len(c),
           c.lookup(q, 3, opts, now_s=0.0)]
    return out


def test_exact_tier_ttl_expiry():
    assert both(_ttl) == ["exact", None, 1, 0, None]


def _boundary(m):
    c = m.serve.QueryCache(m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9,
                                               semantic_threshold=4.0), **m.kw)
    q = np.zeros(4, np.float32)
    opts = (None, None, None)
    ids = np.array([7, 8, -1])
    c.insert(q, 3, opts, ids, np.array([0.5, 0.6, np.inf]), now_s=0.0)
    at = q.copy()
    at[0] = 2.0                     # squared L2 distance exactly 4.0
    hit = c.lookup(at, 3, opts, now_s=1.0)
    beyond = q.copy()
    beyond[0] = np.float32(2.001)
    return [hit.tier, hit.ids.tolist(), c.lookup(beyond, 3, opts, now_s=1.0),
            c.lookup(at, 5, opts, now_s=1.0),
            (c.stats.cache_hits_semantic, c.stats.cache_misses)]


def test_semantic_threshold_boundary_inclusive():
    assert both(_boundary) == ["semantic", [7, 8, -1], None, None, (1, 2)]


def test_semantic_tier_rejects_non_l2_metric():
    with pytest.raises(AssertionError):
        repro.serve.QueryCache(repro.serve.CacheConfig(enabled=True, semantic_threshold=1.0),
                               metric="ip")
    with pytest.raises(ValueError, match="squared-L2"):
        repro_torch.serve.QueryCache(
            repro_torch.serve.CacheConfig(enabled=True, semantic_threshold=1.0),
            metric="ip", device="cpu")


def _lru(m):
    c = m.serve.QueryCache(m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9,
                                               max_entries=2), **m.kw)
    opts = (None, None, None)
    qs = [np.full(4, i, np.float32) for i in range(3)]
    ids, sc = np.array([1, 2, 3]), np.array([0.1, 0.2, 0.3])
    c.insert(qs[0], 3, opts, ids, sc, now_s=0.0)
    c.insert(qs[1], 3, opts, ids, sc, now_s=0.0)
    out = [c.lookup(qs[0], 3, opts, now_s=0.0) is not None]
    c.insert(qs[2], 3, opts, ids, sc, now_s=0.0)
    out += [c.lookup(q, 3, opts, now_s=0.0) is not None for q in qs]
    return out + [len(c)]


def test_lru_eviction_with_refresh():
    assert both(_lru) == [True, True, False, True, 2]


def test_semantic_scan_runs_on_the_plane_device():
    """The scheduler's cache scans on its data plane's device."""
    x, cfg, data = _plane(PORT)
    srv = repro_torch.serve.HarmonyServer(data, n_nodes=2, device="cpu")
    sched = repro_torch.serve.ServingScheduler(
        srv, repro_torch.serve.SchedulerConfig(
            cache=repro_torch.serve.CacheConfig(enabled=True, semantic_threshold=1.0)), k=3)
    assert sched.cache.device == data.device == srv.device


# ------------------------------------------- virtual-clock scheduler paths
def _sched(m, data, cache, **kw):
    srv = m.serve.HarmonyServer(data, n_nodes=2, **m.kw)
    return srv, m.serve.ServingScheduler(
        srv, m.serve.SchedulerConfig(max_batch=8, cache=cache, **kw), k=3,
        service_time_fn=lambda n: 0.0)


def _coalesce(m):
    x, cfg, data = _plane(m)
    srv, sched = _sched(m, data, m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9))
    req = m.core.SearchRequest(vector=x[0], k=3)
    n = 6
    for i in range(n):
        sched.submit(req, i * 1e-6)
    res = sched.flush()
    assert len(res) == n and srv.stats.queries == 1
    assert srv.stats.coalesced == n - 1
    for r in res[1:]:
        assert r.batch_id == res[0].batch_id
        assert np.array_equal(r.ids, res[0].ids)
        assert np.array_equal(r.scores, res[0].scores)
    rid = sched.submit(req, 1.0)
    late = [r for r in sched.done if r.req_id == rid]
    assert late and np.array_equal(late[0].ids, res[0].ids)
    st = srv.stats
    assert st.offered == (st.admitted + st.shed + st.expired_requests
                          + st.cache_hits_exact + st.cache_hits_semantic)
    return counters(st), res[0].ids.tolist()


def test_scheduler_coalesces_duplicates_to_one_execution():
    c, _ = both(_coalesce)
    assert c["cache_hits_exact"] == 1 and c["queries"] == 1


def _semantic(m):
    x, cfg, data = _plane(m)
    srv, sched = _sched(m, data, m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9,
                                                     semantic_threshold=4.0))
    sched.submit(m.core.SearchRequest(vector=x[0], k=3), 0.0)
    sched.advance(0.5)
    first = sched.done[-1]
    near = x[0].copy()
    near[0] += 1.0
    sched.submit(m.core.SearchRequest(vector=near, k=3), 1.0)
    assert np.array_equal(sched.done[-1].ids, first.ids)
    assert np.array_equal(sched.done[-1].scores, first.scores)
    return counters(srv.stats), first.ids.tolist()


def test_scheduler_semantic_hit_replays_neighbor_answer():
    c, _ = both(_semantic)
    assert c["cache_hits_semantic"] == 1 and c["queries"] == 1


def _invalidation(m):
    x, cfg, data = _plane(m)
    srv, sched = _sched(m, data, m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9))
    req = m.core.SearchRequest(vector=x[0], k=3)

    def probe(t):
        h0 = srv.stats.cache_hits_exact
        sched.submit(req, t)
        sched.advance(t + 0.5)
        return srv.stats.cache_hits_exact > h0

    seen = [probe(1.0), probe(2.0)]
    srv.upsert([500], x[:1] + 1.0)
    seen += [probe(3.0), probe(4.0)]
    srv.delete([500])
    seen += [probe(5.0), probe(6.0)]
    gen0 = data.generation
    data.compact_inline(merge_all=True)
    assert data.generation > gen0
    seen.append(probe(7.0))
    return seen, counters(srv.stats)


def test_scheduler_cache_invalidation_on_writes_and_adopt():
    seen, c = both(_invalidation)
    assert seen == [False, True, False, True, False, True, False]
    assert c["cache_invalidations"] >= 3


def _staleness(m):
    x, cfg, data = _plane(m)
    srv, sched = _sched(m, data, m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9,
                                                     staleness_s=10.0))
    req = m.core.SearchRequest(vector=x[0], k=3)
    sched.submit(req, 1.0)
    sched.advance(1.5)
    srv.upsert([501], x[:1] - 1.0)
    sched.submit(req, 5.0)
    hits = [srv.stats.cache_hits_exact]
    sched.submit(req, 30.0)
    return hits + [srv.stats.cache_hits_exact, srv.stats.cache_invalidations]


def test_scheduler_staleness_budget_bounds_serving_across_writes():
    assert both(_staleness) == [1, 1, 1]


# --------------------------------------------------- per-request deadlines
def _expired_at_submit(m):
    x, cfg, data = _plane(m)
    srv, sched = _sched(m, data, m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9))
    sched.submit(m.core.SearchRequest(vector=x[0], k=3), 1.0)
    sched.advance(1.5)
    rid = sched.submit(m.core.SearchRequest(vector=x[0], k=3, deadline=2.5), 3.0)
    r = [d for d in sched.done if d.req_id == rid][0]
    assert (r.ids == -1).all() and np.isinf(r.scores).all() and r.batch_id == -1
    return counters(srv.stats)


def test_scheduler_deadline_expired_at_submit_is_shed_with_sentinel():
    c = both(_expired_at_submit)
    assert c["expired_requests"] == 1 and c["cache_hits_exact"] == 0


def _expired_in_queue(m):
    x, cfg, data = _plane(m)
    srv = m.serve.HarmonyServer(data, n_nodes=2, **m.kw)
    sched = m.serve.ServingScheduler(srv, m.serve.SchedulerConfig(max_batch=8, max_wait_s=1.0),
                                     k=3, service_time_fn=lambda n: 0.0)
    sched.submit(m.core.SearchRequest(vector=x[0], k=3, deadline=0.3), 0.0)
    sched.submit(m.core.SearchRequest(vector=x[1], k=3), 0.01)
    dead, live = sched.flush()
    assert (dead.ids == -1).all() and np.isinf(dead.scores).all()
    assert dead.batch_id == live.batch_id == 0 and (live.ids >= 0).any()
    return counters(srv.stats), live.ids.tolist()


def test_scheduler_deadline_expired_in_queue_degrades_not_executes():
    c, _ = both(_expired_in_queue)
    assert c["expired_requests"] == 1 and c["queries"] == 1 and c["deadline_batches"] == 1


def _all_expired(m):
    x, cfg, data = _plane(m)
    srv = m.serve.HarmonyServer(data, n_nodes=2, **m.kw)
    seen = []
    sched = m.serve.ServingScheduler(
        srv, m.serve.SchedulerConfig(max_batch=8, max_wait_s=1.0), k=3,
        service_time_fn=lambda n: 0.0, on_batch=lambda bid, s: seen.append(bid))
    sched.submit(m.core.SearchRequest(vector=x[0], k=3, deadline=0.3), 0.0)
    res = sched.flush()
    assert (res[0].ids == -1).all()
    return counters(srv.stats), seen


def test_scheduler_all_expired_batch_consumes_id_without_trigger():
    c, seen = both(_all_expired)
    assert c["expired_requests"] == 1 and c["queries"] == 0 and seen == [0]
    assert c["full_batches"] + c["deadline_batches"] + c["capacity_batches"] == 0


# ----------------------------------------------- wall-clock front-end paths
def _frontend_stack():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 8)).astype(np.float32)
    cfg = repro_torch.config.HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3,
                                           kmeans_iters=2)
    return x, repro_torch.serve.HarmonyServer(
        repro_torch.core.build_ivf(x, cfg, device="cpu"), n_nodes=2, device="cpu")


@retry_flaky(times=3)
def test_frontend_inflight_coalescing_and_clean_shutdown():
    S = repro_torch.serve
    x, srv = _frontend_stack()
    fe = S.ServingFrontend(
        srv, S.SchedulerConfig(max_batch=4, max_wait_s=1.0,
                               cache=S.CacheConfig(enabled=True, exact_ttl_s=60.0)),
        k=3, service_time_fn=lambda n: 0.05)
    try:
        req = repro_torch.core.SearchRequest(vector=x[0], k=3)
        n = 5
        futs = [fe.submit(req) for _ in range(n)]
        assert fe.drain(timeout=30.0)
        res = [f.result(timeout=30.0) for f in futs]
        assert srv.stats.coalesced == n - 1 and srv.stats.queries == 1
        for r in res[1:]:
            assert np.array_equal(r.ids, res[0].ids)
            assert np.array_equal(r.scores, res[0].scores)
        late = fe.submit(req).result(timeout=30.0)
        assert srv.stats.cache_hits_exact == 1 and late.batch_id == -1
        assert np.array_equal(late.ids, res[0].ids)
        st = srv.stats
        assert st.offered == (st.admitted + st.shed + st.expired_requests
                              + st.coalesced + st.cache_hits_exact
                              + st.cache_hits_semantic)
    finally:
        assert fe.shutdown(wait=True)
    assert srv.stats.shutdown_leaks == 0
    assert not fe._futures and not fe._followers and not fe._leaders


def test_frontend_shutdown_nowait_drops_queued_leader_and_followers():
    S = repro_torch.serve
    x, srv = _frontend_stack()
    fe = S.ServingFrontend(
        srv, S.SchedulerConfig(max_batch=64, max_wait_s=5.0,
                               cache=S.CacheConfig(enabled=True, exact_ttl_s=60.0)), k=3)
    futs = [fe.submit(repro_torch.core.SearchRequest(vector=x[0], k=3)) for _ in range(3)]
    assert srv.stats.coalesced == 2
    fe.shutdown(wait=False)
    assert all(f.cancelled() for f in futs)
    assert not fe._futures and not fe._followers and not fe._leaders
    assert srv.stats.shutdown_leaks == 0


def test_frontend_deadline_expired_at_submit():
    x, srv = _frontend_stack()
    with repro_torch.serve.ServingFrontend(
            srv, repro_torch.serve.SchedulerConfig(max_batch=4), k=3) as fe:
        r = fe.submit(repro_torch.core.SearchRequest(vector=x[0], k=3, deadline=-1.0)
                      ).result(timeout=30.0)
    assert (r.ids == -1).all() and np.isinf(r.scores).all() and r.batch_id == -1
    assert srv.stats.expired_requests == 1


# ------------------------------------------------------- P11 (fixed grid)
THRESHOLD = 4.0                     # semantic tier, squared-L2 score space


def _mk_stack(m, x, cfg, backend, cache):
    data = m.core.SegmentedIndex.build(x, cfg, **m.kw)
    srv = m.serve.HarmonyServer(
        data, n_nodes=2, backend=backend,
        executor_cfg=m.ExecutorConfig(qb_buckets=(8,), chunk=64, **m.exec_kw), **m.kw)
    sched = m.serve.ServingScheduler(
        srv, m.serve.SchedulerConfig(max_batch=1, cache=cache), k=cfg.topk,
        service_time_fn=lambda n: 0.0)
    return data, srv, sched


def run_cache_interleaving(data_seed, backend, precision, ops, m=PORT):
    """The body of ``cache_invariants.run_cache_interleaving`` over the
    package ``m``: replay one interleaving on the cached stack and its
    cache-off twin, asserting the P11 invariants after every search.
    Returns the tier of every search and the cached stack's counters."""
    nb, dim, k = 64, 8, 4
    rng0 = np.random.default_rng(data_seed)
    x = rng0.standard_normal((nb, dim)).astype(np.float32)
    cfg = m.cfg(dim=dim, nlist=4, nprobe=4, topk=k, kmeans_iters=2, rerank_factor=32)
    ccfg = m.serve.CacheConfig(enabled=True, exact_ttl_s=1e9,
                               semantic_threshold=THRESHOLD, staleness_s=0.0)
    data_a, srv_a, sa = _mk_stack(m, x, cfg, backend, ccfg)
    data_b, srv_b, sb = _mk_stack(m, x, cfg, backend, None)

    history, tiers = [], []
    live = set(range(nb))
    deleted: set = set()
    next_id = nb
    t = 0.0

    def ask(v):
        nonlocal t
        t += 1.0
        st = srv_a.stats
        before = (st.cache_hits_exact, st.cache_hits_semantic)
        req = m.core.SearchRequest(vector=v, k=k, precision=precision)
        results = []
        for sched in (sa, sb):
            n0 = len(sched.done)
            sched.submit(req, t)
            sched.advance(t + 0.5)
            new = sched.done[n0:]
            assert len(new) == 1, "one submission must yield one result"
            results.append(new[0])
        if st.cache_hits_exact > before[0]:
            tier = "exact"
        elif st.cache_hits_semantic > before[1]:
            tier = "semantic"
        else:
            tier = "miss"
        history.append(v)
        return results[0], results[1], tier

    def check(v):
        ra, rb, tier = ask(v)
        if tier == "semantic":
            fin_a, fin_b = np.isfinite(ra.scores), np.isfinite(rb.scores)
            assert np.array_equal(fin_a, fin_b), (
                "semantic hit padded differently than the fresh answer")
            r = np.sqrt(THRESHOLD)
            gap = np.abs(np.sqrt(ra.scores[fin_a]) - np.sqrt(rb.scores[fin_b]))
            assert gap.max(initial=0.0) <= r + 1e-3, (
                f"semantic hit drifted past the threshold: {gap.max()}")
            got = ra.ids[ra.ids >= 0]
            assert not np.isin(got, sorted(deleted) or [-999]).any(), (
                "semantic hit served a deleted id")
        else:
            assert np.array_equal(ra.ids, rb.ids), f"{tier}: ids diverged from the twin"
            assert np.array_equal(ra.scores, rb.scores), (
                f"{tier}: scores diverged from the twin")
        tiers.append(tier)
        return tier

    for kind, s in ops:
        r = np.random.default_rng(s)
        if kind == "fresh":
            check(r.standard_normal(dim).astype(np.float32))
        elif kind == "repeat":
            if not history:
                check(r.standard_normal(dim).astype(np.float32))
            else:
                v = history[int(r.integers(0, len(history)))]
                check(v.copy())
        elif kind == "near":
            if not history:
                check(r.standard_normal(dim).astype(np.float32))
            else:
                v = history[int(r.integers(0, len(history)))]
                jit = r.standard_normal(dim).astype(np.float32)
                jit *= np.sqrt(0.8 * THRESHOLD) / max(float(np.linalg.norm(jit)), 1e-9)
                check((v + jit).astype(np.float32))
        elif kind == "upsert":
            v = r.standard_normal((1, dim)).astype(np.float32)
            if live and r.integers(2):
                tid = sorted(live)[int(r.integers(0, len(live)))]
            else:
                tid = next_id
                next_id += 1
            for srv in (srv_a, srv_b):
                srv.upsert([tid], v)
            live.add(tid)
            deleted.discard(tid)
        elif kind == "delete":
            if live:
                tid = sorted(live)[int(r.integers(0, len(live)))]
                for srv in (srv_a, srv_b):
                    srv.delete([tid])
                live.discard(tid)
                deleted.add(tid)
        elif kind == "compact":
            gen0 = data_a.generation
            for data in (data_a, data_b):
                data.compact_inline(merge_all=bool(s % 2))
            if history and data_a.generation != gen0:
                v = history[int(r.integers(0, len(history)))]
                assert check(v.copy()) == "miss", "cache hit served across a generation swap"

    st = srv_a.stats
    assert st.offered == len(sa.done)
    assert st.offered == (st.admitted + st.shed + st.expired_requests
                          + st.cache_hits_exact + st.cache_hits_semantic)
    return tiers, counters(st)


P11_OPS = [
    ("fresh", 1), ("repeat", 2), ("near", 3), ("upsert", 4), ("repeat", 5),
    ("compact", 6), ("repeat", 7), ("delete", 8), ("near", 9), ("fresh", 10),
    ("repeat", 11), ("compact", 13), ("repeat", 14),
]


@pytest.mark.parametrize("backend", ["host", "spmd"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_p11_cached_serving_matches_cache_off_twin_grid(backend, precision):
    tiers, c = run_cache_interleaving(0, backend, precision, P11_OPS)
    want_tiers, want_c = run_cache_interleaving(0, backend, precision, P11_OPS, m=REF)
    assert tiers == want_tiers and c == want_c
    assert {"exact", "semantic", "miss"} <= set(tiers)
