"""The check that decides ``correct`` fails what it has to fail.

* The control: the plain reference put in the program's place in TF32,
  the precision below the configuration's float32 (here emulated: the
  products' operands rounded to TF32's mantissa), is judged not correct
  under every configuration's limits, by the harness's own rule; and a
  whole run with the control in place of the engine comes out not
  correct.
* Faults: a whole run on the CPU with the served path broken underneath
  the harness (an answer altered where it is produced; half of each
  batch left out; each batch answered with the previous batch's
  answers, a step that hands back its state unchanged) comes out not
  correct. The cells run on one card, so no exchange between cards
  exists to leave out.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import control, gen, harness, tiny

CPU = torch.device("cpu")
CONFIGS = [c["name"] for c in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["configs"]]


def _limits(config):
    return json.loads((tiny.ROOT / "perfbench" / "configs" / f"{config}.json")
                      .read_text())["limits"]


def _correct(numbers, limits):
    return harness.judge_limits(numbers, limits)[1]


@pytest.mark.parametrize("config", CONFIGS)
def test_control_in_tf32_is_not_correct(config):
    cfg = dict(tiny.tiny_config(config), dim=64, n_base=6000)
    limits = _limits(config)
    ref = harness.reference_module(tiny.ROOT, cfg)
    inp = gen.make_inputs(cfg, 3, CPU)
    q = torch.as_tensor(next(gen.request_queries(cfg, dict(tiny.tiny_traffic(),
                                                            queries_per_request=200),
                                                 inp.centres, 3, 0)))
    truth = ref.reference(inp.x, inp.centroids, q, cfg["nprobe"], cfg["k"])
    pool = torch.arange(q.shape[0])
    for emulate, correct in ((True, False), (False, True)):     # TF32; float32, TF32 off
        ids, sc = ref.Control(inp.x, inp.centroids, cfg["nprobe"], emulate).search(q, cfg["k"])
        numbers = ref.judge(inp.x, q, truth, pool, ids, sc)
        assert _correct(numbers, limits) is correct, numbers


def test_a_run_with_the_control_in_place_is_not_correct(tmp_path):
    root = tiny.make_copy(tmp_path, dim=64, n_base=6000)
    cell = harness.load_cell(root, tiny.WORKLOAD)
    seed = 2 ** 31 + 5
    inputs = gen.make_inputs(cell.config, seed, CPU)
    ref = harness.reference_module(root, cell.config)
    with control.control_in_place(ref, inputs, cell.config["nprobe"], CPU, emulate=True):
        out = harness.run_cell(root, cell, seed, 1.0, False, CPU, time.perf_counter(),
                               log=lambda *a, **k: None)
    assert out["correct"] is False, out["checks"]


def _alter_one(res, queries, state):
    res.ids[0, 0] = res.ids[0, -1]               # one answer altered


def _half_left_out(res, queries, state):
    h = len(queries) // 2
    res.ids[h:] = res.ids[:len(queries) - h]     # the second half gets the first's answers
    res.scores[h:] = res.scores[:len(queries) - h]


def _stale(res, queries, state):
    prev = state.get("prev")
    state["prev"] = (res.ids.copy(), res.scores.copy())
    if prev is not None and len(prev[0]) == len(res.ids):
        res.ids[:], res.scores[:] = prev


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", [_alter_one, _half_left_out, _stale],
                         ids=["answer_altered", "half_left_out", "state_unchanged"])
def test_a_broken_path_is_not_correct(copy, monkeypatch, fault):
    from repro_torch.serve import executor

    orig = executor.SpmdExecutor.search_batch
    state = {}

    def broken(self, queries, *a, **kw):
        res = orig(self, queries, *a, **kw)
        fault(res, queries, state)
        return res

    monkeypatch.setattr(executor.SpmdExecutor, "search_batch", broken)
    cell = harness.load_cell(copy, tiny.WORKLOAD)
    out = harness.run_cell(copy, cell, 99, 1.0, False, CPU, time.perf_counter(),
                           log=lambda *a, **k: None)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


@pytest.mark.cuda
def test_control_in_tf32_on_the_card(cuda_device):
    """The same control with the card's own TF32 products."""
    cfg = dict(tiny.tiny_config(), dim=128, n_base=20000, nlist=64)
    ref = harness.reference_module(tiny.ROOT, cfg)
    inp = gen.make_inputs(cfg, 3, cuda_device)
    q = torch.as_tensor(next(gen.request_queries(cfg, dict(tiny.tiny_traffic(),
                                                            queries_per_request=500),
                                                 inp.centres, 3, 0)), device=cuda_device)
    truth = ref.reference(inp.x, inp.centroids, q, cfg["nprobe"], cfg["k"])
    ids, sc = ref.Control(inp.x, inp.centroids, cfg["nprobe"]).search(q, cfg["k"])
    numbers = ref.judge(inp.x, q, truth, torch.arange(500, device=cuda_device), ids, sc)
    assert not _correct(numbers, _limits("sift1m-ivf1024-flat")), numbers


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 products exist only there")
    return torch.device("cuda", 0)
