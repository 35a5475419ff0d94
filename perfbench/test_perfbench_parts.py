"""The benchmark's parts on the CPU: lookup by name, the generators, the
reference against brute force, the work count, the import check and the
trace reader."""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import gen, harness, trace, work
from perfbench.tiny import ROOT, tiny_config, tiny_traffic

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == workload)
    assert {"clients", "queries_per_request", "skew"} <= set(cell.traffic)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(ROOT, m["name"]))
    ref = harness.reference_module(ROOT, cell.config)
    assert callable(ref.reference) and callable(ref.judge)
    assert set(cell.config["limits"]) == {"bad_answers", "rank_excess", "score_err"}


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (ROOT / "perfbench" / "traffic")
                                            .glob("*.json")))
def test_every_traffic_file_is_a_closed_loop_the_generator_reads(traffic):
    tr = json.loads((ROOT / "perfbench" / "traffic" / f"{traffic}.json").read_text())
    assert tr["loop"] == "closed" and tr["clients"] * tr["queries_per_request"] > 0
    assert 0.0 <= tr["skew"] < 1.0 and 0.0 < tr["hot_fraction"] <= 1.0
    cfg = tiny_config()
    centres = torch.randn(cfg["assumed"]["mixture"]["components"], cfg["dim"])
    q = next(gen.request_queries(cfg, tr, centres, 2 ** 31 + 3, 0))
    assert q.shape == (tr["queries_per_request"], cfg["dim"]) and q.dtype == np.float32


def test_config_files_hold_every_reduced_key():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg)


def test_generators_repeat_from_a_seed():
    cfg, tr = tiny_config(), tiny_traffic()
    seed = 2 ** 31 + 12345
    a = gen.make_inputs(cfg, seed, CPU)
    b = gen.make_inputs(cfg, seed, CPU)
    c = gen.make_inputs(cfg, seed + 1, CPU)
    for name in ("x", "centroids", "centres"):
        assert torch.equal(getattr(a, name), getattr(b, name))
        assert not torch.equal(getattr(a, name), getattr(c, name))
    assert a.x.shape == (cfg["n_base"], cfg["dim"])
    assert a.centroids.shape == (cfg["nlist"], cfg["dim"])
    p1, p2, p3 = (gen.request_queries(cfg, tr, a.centres, s, client)
                  for s, client in ((seed, 3), (seed, 3), (seed, 4)))
    sent = []
    for _ in range(3):
        r = next(p1)
        assert np.array_equal(r, next(p2))
        sent += [r, next(p3)]
    # fresh queries: none repeats across requests and clients, none is a corpus row
    rows = np.concatenate(sent)
    assert len(np.unique(rows, axis=0)) == len(rows)
    assert float(torch.cdist(torch.as_tensor(rows), a.x).min()) > 1e-3
    s1 = gen.check_sample(seed, 1000, 100)
    assert np.array_equal(s1, gen.check_sample(seed, 1000, 100))
    assert len(np.unique(s1)) == 100 and np.all(np.diff(s1) > 0) and s1[-1] < 1000
    assert not np.array_equal(s1, gen.check_sample(seed + 1, 1000, 100))
    assert np.array_equal(gen.check_sample(seed, 50, 100), np.arange(50))


def test_skew_puts_its_share_on_the_hot_components():
    cfg, tr = tiny_config(), dict(tiny_traffic(), skew=0.9, hot_fraction=0.1)
    _, centres = gen.make_corpus(cfg, gen.generator(7, CPU), CPU)
    plan = gen.request_queries(cfg, dict(tr, queries_per_request=2000), centres, 7, 0)
    q = torch.as_tensor(next(plan))
    nearest = torch.cdist(q, centres).argmin(1)
    n_hot = round(0.1 * centres.shape[0])
    share = float((nearest < n_hot).float().mean())
    assert 0.8 < share < 0.97


def _brute_ivf(x, cent, q, nprobe, k):
    """Float64 IVF-Flat by the definition, one query at a time."""
    x, cent, q = (np.asarray(t, np.float64) for t in (x, cent, q))
    lists = ((x[:, None, :] - cent[None]) ** 2).sum(2).argmin(1)
    out = []
    for qi in q:
        probes = np.argsort(((cent - qi) ** 2).sum(1), kind="stable")[:nprobe]
        rows = np.nonzero(np.isin(lists, probes))[0]
        d = ((x[rows] - qi) ** 2).sum(1)
        out.append(np.sort(d)[:k])
    return np.array(out)


def test_reference_equals_brute_force():
    cfg = tiny_config()
    inp = gen.make_inputs(cfg, 11, CPU)
    queries = torch.as_tensor(next(gen.request_queries(cfg, tiny_traffic(), inp.centres, 11, 0)))
    ref = harness.reference_module(ROOT, cfg)
    truth = ref.reference(inp.x, inp.centroids, queries, cfg["nprobe"], cfg["k"])
    want = _brute_ivf(inp.x, inp.centroids, queries, cfg["nprobe"], cfg["k"])
    np.testing.assert_allclose(truth.d_certain.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(truth.d_possible.numpy(), want, rtol=1e-12)
    # the answer it would give is judged right, and an off-by-one wrong
    d = ((queries.double()[:, None] - inp.x.double()[None]) ** 2).sum(2)
    lists = truth.lists.of_row
    probed = torch.zeros((len(queries), cfg["nlist"]), dtype=torch.bool)
    probed.scatter_(1, truth.probes, True)
    d = torch.where(probed[:, lists], d, torch.inf)
    top = torch.topk(d, cfg["k"], dim=1, largest=False)
    pool = torch.arange(len(queries))
    assert torch.equal(work.probes(queries, inp.centroids, cfg["nprobe"]).sort(1).values,
                       truth.probes.sort(1).values)
    good = ref.judge(inp.x, queries, truth, pool, top.indices, top.values.float())
    assert good["bad_answers"] == 0 and good["rank_excess"] < 1e-12
    assert good["score_err"] < 1e-6
    worse = top.indices.clone()
    worse[0, 0] = torch.topk(d[0], cfg["k"] + 1, largest=False).indices[-1]
    bad = ref.judge(inp.x, queries, truth, pool, worse, top.values.float())
    assert bad["rank_excess"] > 1e-4 or bad["bad_answers"] > 0


def test_rounding_ties_are_open_both_ways():
    """A row half-way between two centroids may be in either list."""
    ref = harness.reference_module(ROOT, tiny_config())
    cent = torch.tensor([[0.0, 0.0], [2.0, 0.0], [9.0, 9.0]])
    x = torch.tensor([[1.0, 0.1], [0.2, 0.0], [1.9, 0.0]])
    lists = ref.assign_lists(x, cent)
    assert lists.amb_rows.tolist() == [0]
    assert sorted(lists.amb_lists[0].tolist()) == [0, 1]
    certain, possible, _ = ref.probe_sets(torch.tensor([[-0.5, 0.0]]), cent, 1)
    assert certain.tolist() == [[True, False, False]]
    assert possible.tolist() == [[True, False, False]]


def test_work_count_by_hand():
    sizes = torch.tensor([10, 20, 30, 40])
    probes = torch.tensor([[0, 1], [1, 3], [1, 0]])
    flops, nbytes = work.batch_work(probes, sizes, dim=8, k=5)
    assert flops == 2 * 8 * ((10 + 20) + (20 + 40) + (20 + 10))
    assert nbytes == 4 * 8 * (10 + 20 + 40) + 4 * 8 * 3 + 8 * 5 * 3
    peak = {"fp32_flops_per_s": 1e3, "hbm_bytes_per_s": 1e4}
    assert work.least_seconds(flops, nbytes, peak) == max(flops / 1e3, nbytes / 1e4)
    assert work.peaks("NVIDIA H100 80GB HBM3")["fp32_flops_per_s"] == 67e12
    assert work.peaks("a card the table lacks") is None


def test_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro", "repro.core",
             "repro_torch", "repro_torch.serve", "reprolib", "jaxtyping", "perfbench"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy",
                                                 "jaxlib.xla_client", "repro", "repro.core"]


class _Ev:
    def __init__(self, name, a, b, dev, kind):
        self._n, self._a, self._b, self._d, self._k = name, a, b, dev, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._k == "user_annotation"


def test_trace_reader_by_hand():
    ev = [
        _Ev(trace.WINDOW, 1000, 2000, False, "user_annotation"),
        _Ev("k1", 1200, 1300, True, "kernel"),
        _Ev("k1", 1250, 1350, True, "kernel"),       # overlaps: busy once
        _Ev("k2", 1500, 1550, True, "kernel"),
        _Ev("Memcpy", 1700, 1720, True, "gpu_memcpy"),
        _Ev("k3", 900, 1010, True, "kernel"),       # cut at the window's edge
        _Ev(trace.WINDOW, 1000, 2000, True, "user_annotation"),    # its device mirror
        _Ev(trace.SYNC + "0", 960, 961, False, "user_annotation"),
        _Ev(trace.SYNC + "1", 990, 991, False, "user_annotation"),
    ]
    probes = [(-60, 0), (-11, -9)]          # probe 1 is the tighter: shift 1000
    # host spans on a clock 1000 behind the profiler's
    spans = [(100, 600, trace.BATCH + "7"), (150, 590, "ring.ring_chunk_search"),
             (-500, -100, trace.BATCH + "6")]
    s = trace.summarize(ev, spans, probes)
    assert s.window_s == 1000 / 1e9
    assert s.busy_s == (10 + 150 + 50 + 20) / 1e9
    assert s.launches == 4
    assert s.batch_device_s == {7: 200 / 1e9}
    assert s.batch_launches == {7: 3}
    assert s.device_ops[0] == ("k1", 200 / 1e9)
    gaps = dict(s.idle_gaps)
    # 1010-1100: no span; 1100-1150 the batch span; 1150-1200 and
    # 1350-1500 the ring (opened at 1150, shut at 1590); 1550-1590 the
    # ring, 1590-1600 the batch, 1600-1700 and 1720-2000 none
    assert gaps[trace.BATCH.split("#")[0]] == pytest.approx((50 + 10) / 1e9)
    assert gaps["ring.ring_chunk_search"] == pytest.approx((50 + 150 + 40) / 1e9)
    assert gaps[trace.HOST_OTHER] == pytest.approx((90 + 100 + 280) / 1e9)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    assert trace.summarize(ev[1:], spans, probes) is None


def test_device_operations_go_by_short_names():
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"
    assert trace.short_name(
        "void (anonymous namespace)::partial_distance_kernel<float>(float const*, int)"
    ) == "partial_distance_kernel"
    assert trace.short_name(
        "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
        "at::native::BinaryFunctor<int, int, bool, at::native::(anonymous namespace)::"
        "CompareEqFunctor<int> > >(at::TensorIteratorBase&)") == "elementwise_kernel.CompareEqFunctor"


def test_spans_time_each_layer_and_come_out_again(monkeypatch):
    from repro_torch.serve import engine, executor

    gone = ("executor", "SpmdExecutor", "a_name_the_program_lacks", "executor.gone")
    monkeypatch.setattr(trace, "LAYER_ENTRIES", trace.LAYER_ENTRIES + (gone,))
    before = executor.SpmdExecutor.__dict__["search_batch"]
    sink, ticks = [], iter(range(0, 10 ** 6, 10))
    with trace.spans(sink, lambda: next(ticks)) as absent:
        assert absent == ["executor.gone"]
        assert executor.SpmdExecutor.__dict__["search_batch"] is not before
        executor.ring_chunk_search.__wrapped__      # wrapped in place
        index = types.SimpleNamespace(centers=np.eye(4, dtype=np.float32),
                                      cfg=types.SimpleNamespace(nprobe=1))
        engine.assign_queries(index, np.eye(4, dtype=np.float32)[:2])
    assert executor.SpmdExecutor.__dict__["search_batch"] is before
    assert not hasattr(engine.assign_queries, "__wrapped__")
    assert sink == [(0, 10, "engine.assign_queries")]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = types.SimpleNamespace(workload=BENCH["workloads"][0]["name"], seed=1,
                                 seconds=1.0, trace=0)
    assert harness.main(args, ROOT, 0.0) == 2
    assert capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""
    assert Path(tmp_path / "perfbench" / "run.py").exists()
