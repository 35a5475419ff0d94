"""The port's tracer (``repro_torch.tracing``) on the CPU: nothing is
recorded while it is off; one batch through the live front end over the
spmd executor gives the serving path's tree of spans, whether an operator
turned tracing on or a profiler collects in another thread; threads
recording at once each keep their own parents; the spans share the
profiler's clock; the executor's ``pairs_needed`` matches a
hand count; and the benchmark's five readers of the spans give
hand-worked values."""

import contextlib
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from perfbench import harness, tiny
from repro_torch import tracing
from repro_torch.config import HarmonyConfig
from repro_torch.core import SearchRequest, build_ivf
from repro_torch.serve import (ExecutorConfig, HarmonyServer, SchedulerConfig,
                               ServingFrontend)
from repro_torch.serve.executor import SpmdExecutor

WAIT = 60.0
NQ = 24

# each span of one serving batch, under its parent
TREE = {
    "frontend.batch": None,
    "frontend.stack": "frontend.batch",
    "engine.search_batch": "frontend.batch",
    "engine.assign_queries": "engine.search_batch",
    "executor.search_batch": "engine.search_batch",
    "executor.gather_rows": "executor.search_batch",
    "executor.prewarm_tau": "executor.search_batch",
    "executor.upload": "executor.search_batch",
    "ring.enqueue": "executor.search_batch",
    "executor.wait": "executor.search_batch",
    "frontend.fanout": "frontend.batch",
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    cfg = HarmonyConfig(dim=16, nlist=12, nprobe=3, topk=5, kmeans_iters=2)
    return x, build_ivf(x, cfg, device="cpu")


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def one_batch(data, how: str):
    """Serve one full batch of NQ queries, its front end and warm-up made
    first. ``how``: ``"off"``; ``"enable"`` calls :func:`tracing.enable`;
    ``"profiler"`` opens a profiler in this thread around the batch,
    which runs in the front end's worker. Returns the answers once the
    batch's span has closed."""
    x, index = data
    srv = HarmonyServer(index, n_nodes=1, backend="spmd", device="cpu",
                        executor_cfg=ExecutorConfig(chunk=64, qb_buckets=(32,)))
    done = threading.Event()
    with ServingFrontend(srv, SchedulerConfig(max_batch=NQ, max_wait_s=5.0), k=5,
                         on_batch=lambda bid, fe: done.set()) as fe:
        if how == "enable":
            tracing.enable()
        with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
              if how == "profiler" else contextlib.nullcontext()):
            futs = [fe.submit(SearchRequest(vector=v)) for v in x[:NQ]]
            res = [f.result(timeout=WAIT) for f in futs]
            assert done.wait(WAIT)
        tracing.disable()
    return res


def test_off_records_nothing(data):
    assert tracing.span("a") is tracing.span("b", bid=3, queries=1)
    with tracing.span("a") as sp:
        assert not sp.on
        sp.count(x=1)
        tracing.count(y=2)
    res = one_batch(data, "off")
    assert len(res) == NQ
    assert tracing.spans() == [] and tracing.drain() == []


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_one_batch_gives_the_tree(data, how):
    res = one_batch(data, how)
    spans = tracing.drain()
    by_name = {}
    for s in spans:
        assert s.name not in by_name, s
        by_name[s.name] = s
    assert set(by_name) == set(TREE)
    root = by_name["frontend.batch"]
    assert root.parent is None and root.bid == res[0].batch_id
    assert root.counts == {"queries": NQ, "trigger": "full"}
    by_id = {s.id: s for s in spans}
    for name, parent in TREE.items():
        s = by_name[name]
        assert s.bid == root.bid, s
        if parent is not None:
            assert by_id[s.parent].name == parent, s
            # containment: a child lies inside its parent
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    assert by_name["engine.search_batch"].counts == {"segments": 1}
    assert by_name["engine.assign_queries"].counts == {"on_card": 0}
    ex = by_name["executor.search_batch"].counts
    assert ex["qb"] == 32 and ex["step_built"] is False
    assert 0 < ex["pairs_needed"] <= ex["pairs_scored"]
    assert by_name["ring.enqueue"].counts["chunks"] == ex["cap"] // 64


def test_threads_record_every_span_under_its_own_parent():
    n_threads, n = 16, 300
    tracing.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(n):
                with tracing.span("outer", bid=t):
                    with tracing.span("inner"):
                        tracing.count(i=i)
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        tracing.disable()
    spans = tracing.drain()
    assert len(spans) == 2 * n_threads * n
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer" and by_id[s.parent].bid == s.bid


def test_a_span_is_on_the_profilers_clock():
    offsets = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tracing.span(f"clock{i}") as sp:
                with torch.profiler.record_function(f"clock.range{i}"):
                    pass
            offsets.append((f"clock.range{i}", sp.start_ns))
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()}
    assert min(abs(starts[n] - t) for n, t in offsets) < 1_000_000


@pytest.mark.parametrize("d_blocks", [1, 2])
def test_pairs_needed_is_a_hand_count(data, d_blocks):
    x, index = data
    ex = SpmdExecutor(index, ExecutorConfig(chunk=64, qb_buckets=(8,), d_blocks=d_blocks),
                      device="cpu")
    ex.warmup()
    # a repeated list counts once; -2 pads match nothing
    probes = np.array([[0, 3, 3], [5, 1, -2], [11, 0, 7]], np.int32)
    tracing.enable()
    res = ex.search_batch(x[:3], k=5, probes=probes)
    tracing.disable()
    (sp,) = [s for s in tracing.drain() if s.name == "executor.search_batch"]
    sizes = index.sizes
    hand = sum(int(sizes[c]) for row in probes for c in set(row.tolist()) if c >= 0)
    assert sp.counts["pairs_needed"] == hand * d_blocks
    assert sp.counts["pairs_scored"] == (
        (res.stats["tile_total"] - res.stats["tile_skipped"]) * 128 * 128)


def _stand_in(name, bid, start_ms, end_ms, **counts):
    return types.SimpleNamespace(name=name, bid=bid, start_ns=int(start_ms * 1e6),
                                 end_ns=int(end_ms * 1e6), counts=counts)


READERS = ("probe_select_ms", "tau_prewarm_ms", "device_wait_pct", "fanout_ms",
           "useful_pair_pct")


def _read(name, traced_bids, spans, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    run = types.SimpleNamespace(traced_batches=[types.SimpleNamespace(bid=b)
                                                for b in traced_bids])
    return harness.reader(tiny.ROOT, name)(run)


def test_readers_by_hand(monkeypatch):
    spans = [
        # an earlier front end's batch 1: replaced by the newer batch 1
        _stand_in("engine.assign_queries", 1, -4900, -4000),
        _stand_in("frontend.batch", 1, -5000, -3000),
        # batch 1
        _stand_in("engine.assign_queries", 1, 10, 110),
        _stand_in("executor.prewarm_tau", 1, 120, 170),
        _stand_in("executor.wait", 1, 300, 400),
        _stand_in("executor.search_batch", 1, 110, 510, pairs_needed=30,
                  pairs_scored=100),
        _stand_in("frontend.fanout", 1, 900, 920),
        _stand_in("frontend.batch", 1, 0, 1000),
        # batch 2
        _stand_in("engine.assign_queries", 2, 2000, 2300),
        _stand_in("executor.prewarm_tau", 2, 2300, 2450),
        _stand_in("executor.wait", 2, 2500, 2800),
        _stand_in("executor.search_batch", 2, 2300, 2900, pairs_needed=20,
                  pairs_scored=300),
        _stand_in("frontend.fanout", 2, 2950, 2990),
        _stand_in("frontend.batch", 2, 2000, 3000),
        # batch 3, not wholly inside the traced window
        _stand_in("engine.assign_queries", 3, 4000, 9000),
        _stand_in("frontend.batch", 3, 4000, 9900),
    ]
    want = {"probe_select_ms": 200.0, "tau_prewarm_ms": 100.0, "fanout_ms": 30.0,
            "device_wait_pct": 40.0, "useful_pair_pct": 12.5}
    for name in READERS:
        assert _read(name, [1, 2], spans, monkeypatch) == pytest.approx(want[name]), name
        assert _read(name, [4], spans, monkeypatch) is None, name
        assert _read(name, [1, 2], [], monkeypatch) is None, name
        assert _read(name, [1, 2], [s for s in spans if s.name == "frontend.batch"],
                     monkeypatch) is None, name


def test_a_traced_run_reports_the_five(tmp_path):
    root = tiny.make_copy(tmp_path)
    cell = harness.load_cell(root, tiny.WORKLOAD)
    out = harness.run_cell(root, cell, 2 ** 31 + 78, 1.0, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a, **k: None)
    assert out["correct"] is True, out["checks"]
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["useful_pair_pct"]["value"] <= 100.0
    assert out["metrics"]["device_wait_pct"]["value"] <= 100.0
