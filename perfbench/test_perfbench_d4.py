"""A whole traced run on the CPU of a tiny cell over four dimension blocks,
added to a temporary copy of the benchmark by data files alone: the
answers are correct and ``early_stop_pct`` reads a number."""

from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import harness, tiny


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    assumed = tiny.tiny_config()["assumed"]
    assumed["executor"] = dict(assumed["executor"], d_blocks=4)
    root = tiny.make_copy(tmp_path_factory.mktemp("bench_d4"), assumed=assumed)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "early_stop_pct":
            m["workloads"].append(tiny.WORKLOAD)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_four_block_cell_reads_its_early_stop(copy):
    cell = harness.load_cell(copy, tiny.WORKLOAD)
    assert cell.config["assumed"]["executor"]["d_blocks"] == 4
    out = harness.run_cell(copy, cell, 2 ** 31 + 404, 1.0, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a, **k: None)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    pct = out["metrics"]["early_stop_pct"]
    assert pct["unit"] == "%" and 0.0 <= pct["value"] <= 100.0
