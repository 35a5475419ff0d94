"""One run of one cell: set-up, a closed-loop window through the front
end, the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* ``configs[].file``: the configuration's sizes, its deployment settings
  under ``assumed``, the name of its plain reference (a module under
  ``perfbench/references/``) and the limit of each number compared;
* ``perfbench/traffic/<traffic>.json``: the closed loop and the query
  distribution;
* ``perfbench/metrics/<metric>.py``: a reader, ``read(run)``, that
  returns the metric's value from :class:`Run`, or None where it finds
  nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import queue
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import gen, trace, work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RESULT_WAIT_S = 120.0       # the longest a client waits for an answer past the window


# --------------------------------------------------------------------- lookup
@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(root: Path, workload: str) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(root / conf["file"])
    traffic = _load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py").read


def reference_module(root: Path, config: dict):
    return load_module(root / "perfbench" / "references" / f"{config['reference']}.py")


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's, compared whole."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------- records
@dataclass
class Batch:
    bid: int
    done_s: float
    queries: int
    engine_wall_s: float
    exec_wall_s: float
    tile_skipped: int
    tile_total: int
    trigger: str = ""
    least_s: Optional[float] = None      # the needed work's least time


@dataclass
class Request:
    """One client's call: its query rows [n, D] and, a query each, the
    answer's ids and scores and its batch (-1 where none came)."""

    client: int
    send_s: float
    done_s: float
    queries: np.ndarray
    ids: np.ndarray
    scores: np.ndarray
    batch_ids: np.ndarray
    missing: int = 0


@dataclass
class Run:
    """What the window left behind, for the metric readers."""

    config: dict
    traffic: dict
    seconds: float
    setup_s: float = 0.0
    t0: Optional[float] = None
    t1: Optional[float] = None
    batches: List[Batch] = field(default_factory=list)
    requests: List[Request] = field(default_factory=list)
    memory_peak_bytes: int = 0
    device_kind: str = ""
    trace: Optional[trace.TraceSummary] = None
    stats: dict = field(default_factory=dict)
    batch_spans: Dict[int, tuple] = field(default_factory=dict)   # bid: (dispatch_s, done_s)
    lost: int = 0                        # queries whose answers never came

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, done_s: float) -> bool:
        return self.t0 < done_s <= self.t1

    @property
    def window_batches(self) -> List[Batch]:
        return [b for b in self.batches if self.in_window(b.done_s)]

    @property
    def window_requests(self) -> List[Request]:
        return [r for r in self.requests if self.in_window(r.done_s) and not r.missing]

    @property
    def traced_batches(self) -> List[Batch]:
        if self.trace is None:
            return []
        return [b for b in self.batches if b.bid in self.trace.batch_device_s]


def judge_limits(numbers: dict, limits: dict):
    """Each number compared beside its limit, and whether the run is
    correct: every number at or under its limit."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


# --------------------------------------------------------------- the window
class Window:
    """The closed loop: ``clients`` callers, each sending a request of
    ``queries_per_request`` fresh single-query submissions and sending
    the next once all its answers are in. One thread sends for all of
    them, a request's queries together (as over one connection), so the
    front end's queue holds whole requests in the order they were sent;
    each answer's done-callback counts its request down. ``on_batch``
    marks the window's edges at batch completions."""

    def __init__(self, fe, srv, run: Run, centres: torch.Tensor, seed: int):
        self.fe, self.srv, self.run, self.centres = fe, srv, run, centres
        self.seed = seed
        self.ex = srv.executor
        self.stop_at = float("inf")
        self.armed_at = float("inf")
        self.sync = None
        self.warm = threading.Event()
        self.closed = threading.Event()
        self._prev = (0, 0.0, 0.0, 0, 0, 0, 0)
        self._done: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._drive_clients, name="perfbench-clients",
                                       daemon=True)

    def on_batch(self, bid: int, fe) -> None:
        st, ex = self.srv.stats, self.ex
        cur = (st.queries, st.wall_s, ex.wall_s, ex.tile_skipped, ex.tile_total,
               st.full_batches, st.deadline_batches)
        prev, self._prev = self._prev, cur
        done = fe.last_done_s
        run = self.run
        trig = "full" if cur[5] > prev[5] else "deadline" if cur[6] > prev[6] else "other"
        run.batches.append(Batch(bid=bid, done_s=done, queries=cur[0] - prev[0],
                                 engine_wall_s=cur[1] - prev[1], exec_wall_s=cur[2] - prev[2],
                                 tile_skipped=cur[3] - prev[3], tile_total=cur[4] - prev[4],
                                 trigger=trig))
        if len(run.batches) >= run.traffic["warmup_batches"]:
            self.warm.set()
        if run.t0 is None and done >= self.armed_at:
            run.t0 = done
            self.stop_at = done + run.seconds
        elif run.t0 is not None and run.t1 is None and done >= self.stop_at:
            run.t1 = done
            self.closed.set()

    def clock_ns(self) -> int:
        """The front end's clock, in whole nanoseconds."""
        return round(self.fe.clock.now() * 1e9)

    def _send(self, c: int, plan) -> None:
        from repro_torch.core.types import SearchRequest

        q = next(plan)
        send_s = self.fe.clock.now()
        futs = [self.fe.submit(SearchRequest(vector=row)) for row in q]
        left = [len(futs)]
        mu = threading.Lock()

        def one_done(_f):
            with mu:
                left[0] -= 1
                last = left[0] == 0
            if last:
                self._done.put((c, send_s, q, futs))

        for f in futs:
            f.add_done_callback(one_done)

    def _record(self, c: int, send_s: float, q, futs) -> int:
        k = self.fe.k
        ids = np.full((len(q), k), -1, np.int64)
        scores = np.full((len(q), k), np.inf, np.float32)
        bids = np.full(len(q), -1, np.int64)
        done, missing = send_s, 0
        for j, f in enumerate(futs):
            err = f.exception()
            if err is not None:                     # a shed or a fault
                missing += 1
                print(f"client {c}: no answer: {err!r}", file=sys.stderr)
                continue
            r = f.result()
            ids[j], scores[j], bids[j] = r.ids, r.scores, r.batch_id
            self.run.batch_spans[r.batch_id] = (r.dispatch_s, r.done_s)
            done = max(done, r.done_s)
        self.run.requests.append(Request(c, send_s, done, q, ids, scores, bids, missing))
        return missing

    def _drive_clients(self) -> None:
        n = self.run.traffic["clients"]
        plans = [gen.request_queries(self.run.config, self.run.traffic, self.centres,
                                     self.seed, c) for c in range(n)]
        for c in range(n):
            self._send(c, plans[c])
        busy = n
        while busy:
            try:
                c, send_s, q, futs = self._done.get(timeout=RESULT_WAIT_S)
            except queue.Empty:
                print(f"perfbench: {busy} requests never completed", file=sys.stderr)
                self.run.lost = busy * self.run.traffic["queries_per_request"]
                return
            if self._record(c, send_s, q, futs) or self.fe.clock.now() >= self.stop_at:
                busy -= 1
            else:
                self._send(c, plans[c])

    def drive(self, traced: bool):
        """Warm up, open the window, close it at the first batch that
        completes ``seconds`` after it opened, and wait for every
        answer. Returns the profiler (traced) or None."""
        self.thread.start()
        limit = RESULT_WAIT_S + 60.0
        if not self.warm.wait(timeout=limit):
            raise RuntimeError("the warm-up batches never completed")
        prof = None
        if traced:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            marker = trace.window(self.clock_ns)
            self.sync = marker.__enter__()
        self.armed_at = self.fe.clock.now()
        if not self.closed.wait(timeout=self.run.seconds + limit):
            raise RuntimeError("the window never closed")
        if traced:
            marker.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        self.stop_at = min(self.stop_at, self.fe.clock.now())
        self.thread.join(timeout=limit)
        if self.thread.is_alive():
            raise RuntimeError("the clients never finished")
        return prof


# --------------------------------------------------------------------- a run
def card(device: torch.device) -> dict:
    """The card's name and, from ``nvidia-smi``, its power limit."""
    info = {"kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        idx = device.index or 0
        info["nvidia_smi"] = out[idx] if len(out) > idx else ""
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = "not read"
    return info


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, log=print) -> dict:
    """One run: returns the result dict (the last line's keys)."""
    from repro_torch.config import HarmonyConfig
    from repro_torch.core.index import build_ivf
    from repro_torch.serve import ExecutorConfig, HarmonyServer, SchedulerConfig, ServingFrontend

    cfg, traffic = cell.config, cell.traffic
    assumed = cfg["assumed"]
    ref = reference_module(root, cfg)
    cuda = device.type == "cuda"
    board = card(device) if cuda else {"kind": "cpu"}
    run = Run(config=cfg, traffic=traffic, seconds=seconds, device_kind=board["kind"])
    steps = {}

    def mark(name, t):
        if cuda:
            torch.cuda.synchronize(device)
        steps[name] = time.perf_counter() - t
        return time.perf_counter()

    t = steps_t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    inp = gen.make_inputs(cfg, seed, device)
    t = mark("inputs", t)
    x_np = inp.x.cpu().numpy()
    cent_np = inp.centroids.cpu().numpy()
    centres = inp.centres.cpu()
    del inp
    t = mark("to_host", t)
    hcfg = HarmonyConfig(dim=cfg["dim"], nlist=cfg["nlist"], nprobe=cfg["nprobe"],
                         topk=cfg["k"], metric=cfg["metric"])
    index = build_ivf(x_np, hcfg, centers=cent_np, device=device)
    del x_np
    t = mark("build_ivf", t)
    ex_cfg = dict(assumed["executor"])
    ex_cfg["qb_buckets"] = tuple(ex_cfg["qb_buckets"])
    srv = HarmonyServer(index, n_nodes=assumed["n_nodes"], backend="spmd",
                        executor_cfg=ExecutorConfig(**ex_cfg), device=device)
    t = mark("server", t)
    holder: Dict[str, Window] = {}
    fe = ServingFrontend(srv, SchedulerConfig(**assumed["scheduler"]), k=cfg["k"],
                         on_batch=lambda bid, f: holder["w"].on_batch(bid, f))
    t = mark("frontend_warmup", t)
    win = holder["w"] = Window(fe, srv, run, centres, seed)
    error, host_spans, absent = None, [], []
    try:
        if traced:
            with trace.spans(host_spans, win.clock_ns) as absent:
                prof = win.drive(traced=True)
        else:
            win.drive(traced=False)
    except RuntimeError as e:
        error = e
    finally:
        fe.shutdown(wait=True, timeout=RESULT_WAIT_S)
    if run.t0 is not None:          # everything before the window opened
        run.setup_s = (time.perf_counter() - t_start) - (fe.clock.now() - run.t0)
    steps["warmup_batches"] = run.setup_s - sum(steps.values()) - (steps_t0 - t_start)
    if cuda:
        torch.cuda.synchronize(device)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    st = srv.stats
    run.stats = dict(batches=st.batches, full=st.full_batches, deadline=st.deadline_batches,
                     capacity=st.capacity_batches, shed=st.shed, failed=st.failed_requests,
                     exec=srv.executor.stats_summary()["buckets_compiled"])
    if traced and error is None:
        host_spans += [(round(a * 1e9), round(b * 1e9), f"{trace.BATCH}{bid}")
                       for bid, (a, b) in run.batch_spans.items()]
        run.trace = trace.summarize(prof.profiler.kineto_results.events(), host_spans,
                                    win.sync)
        del prof
    # the program's state goes before the reference runs
    del fe, srv, index, win, holder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(json.dumps({"setup_steps_s": steps, "serve": run.stats, "absent_spans": absent}),
        file=sys.stderr)
    if run.t0 is not None:
        lat = sorted(round((r.done_s - r.send_s) * 1e3) for r in run.window_requests)
        log(json.dumps({"window": [run.t0, run.t1], "requests_ms": lat,
                        "batches": [(b.bid, round(b.done_s - run.t0, 3), b.queries, b.trigger,
                                     round(b.engine_wall_s, 3), round(b.exec_wall_s, 3))
                                    for b in run.batches],
                        "trace_shift_ns": getattr(run.trace, "shift_ns", None)}),
            file=sys.stderr)
    if error is not None:
        raise error

    # ---- the check: a sample of the run's answers, drawn from the seed,
    # against the plain reference; every missing answer counts
    t = time.perf_counter()
    reqs = run.requests
    queries = np.concatenate([r.queries for r in reqs])
    ids = np.concatenate([r.ids for r in reqs])
    scores = np.concatenate([r.scores for r in reqs])
    bids = np.concatenate([r.batch_ids for r in reqs])
    got = np.nonzero(bids >= 0)[0]
    missing = len(bids) - len(got) + run.lost
    pick = got[gen.check_sample(seed, len(got), cfg["check_sample"])]
    inp = gen.make_inputs(cfg, seed, device)
    qs = torch.as_tensor(queries[pick], device=device)
    truth = ref.reference(inp.x, inp.centroids, qs, cfg["nprobe"], cfg["k"])
    numbers = ref.judge(inp.x, qs, truth, torch.arange(len(pick), device=device),
                        torch.as_tensor(ids[pick], device=device),
                        torch.as_tensor(scores[pick], device=device), missing=missing)
    if run.trace is not None and run.device_kind:
        peak = work.peaks(run.device_kind)
        if peak is not None:
            sizes = work.list_sizes(truth.lists.of_row, cfg["nlist"])
            for b in run.traced_batches:
                qb = torch.as_tensor(queries[bids == b.bid], device=device)
                probes = work.probes(qb, inp.centroids, cfg["nprobe"])
                flops, nbytes = work.batch_work(probes, sizes, cfg["dim"], cfg["k"])
                b.least_s = work.least_seconds(flops, nbytes, peak)
    del inp, truth, qs
    log(json.dumps({"check_s": time.perf_counter() - t, "compared": len(pick)}),
        file=sys.stderr)

    checks, correct = judge_limits(numbers, cfg["limits"])
    metrics_def = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in metrics_def:
        v = reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": run.device_kind,
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": int(len(bids) + run.lost),
           "failed": int(numbers["bad_answers"]), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": [list(p) for p in run.trace.device_ops],
                            "idle_gaps": [list(p) for p in run.trace.idle_gaps]}
    out["card"] = board
    out["checks"] = checks
    return out


def main(args, root: Path, t_start: float) -> int:
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; nothing is measured", file=sys.stderr)
        return 2
    cell = load_cell(root, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from repro_torch._device import resolve_device

    device = resolve_device(None)
    out = run_cell(root, cell, args.seed, float(args.seconds), bool(args.trace), device,
                   t_start, log=print)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
