"""A whole run on the CPU at a tiny size, in a temporary copy of the
benchmark to which a cell was added by data files alone."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness, tiny

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def _run(root, traced=False, seconds=1.0):
    cell = harness.load_cell(root, tiny.WORKLOAD)
    return harness.run_cell(root, cell, 2 ** 31 + 77, seconds, traced, CPU,
                            time.perf_counter(), log=lambda *a, **k: None)


def test_a_cell_added_by_data_files_alone_runs(copy):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    assert tiny.WORKLOAD in {w["name"] for w in bench["workloads"]}
    out = _run(copy)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["attempted"] % tiny.tiny_traffic()["queries_per_request"] == 0
    # the result line's keys, in order, with the checks last
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert set(out) == set(KEYS) | {"card", "checks"}
    want = {m["name"] for m in bench["end_to_end"]} - {"device_gb"}   # no card: no peak
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_the_traced_run_adds_breakdown(copy):
    out = _run(copy, traced=True)
    assert out["correct"] is True
    assert list(out)[:5] == KEYS and "breakdown" in out
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    # on the CPU the device readers find nothing and are left out; the
    # counters' readers report
    assert {"serve_gap_pct", "engine_self_ms", "tile_skip_pct"} <= set(out["metrics"])
    assert set(out["metrics"]) <= {m["name"] for m in bench["per_layer"]}
    assert "device_idle_pct" not in out["metrics"]


def test_readers_on_a_window_by_hand():
    run = harness.Run(config={}, traffic={}, seconds=2.0, t0=10.0, t1=12.5)
    for bid, done in enumerate([9.0, 10.0, 11.0, 12.5, 13.0]):
        run.batches.append(harness.Batch(bid=bid, done_s=done, queries=100,
                                         engine_wall_s=0.5, exec_wall_s=0.4,
                                         tile_skipped=1, tile_total=4))
    for i in range(40):                       # latencies 10, 20, ... 400 ms
        done = 10.2 + i * 0.05
        run.requests.append(harness.Request(0, done - (i + 1) / 100, done, None, None, None,
                                            None))
    run.requests.append(harness.Request(0, 9.0, 12.0, None, None, None, None, missing=1))

    def read(name):
        return harness.reader(tiny.ROOT, name)(run)

    # batches 2 and 3 complete in (10, 12.5]; the one at 10.0 opened it
    assert read("qps") == 200 / 2.5
    assert read("serve_gap_pct") == pytest.approx(100 * (1 - 1.0 / 2.5))
    assert read("engine_self_ms") == pytest.approx(100.0)
    assert read("tile_skip_pct") == 25.0
    assert read("request_p95_ms") == pytest.approx(np.percentile(np.arange(1, 41) * 10.0, 95))
    assert read("device_gb") is None and read("device_idle_pct") is None
    assert read("launches_per_query") is None and read("search_roofline") is None
