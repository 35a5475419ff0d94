"""A temporary copy of the benchmark with one more cell at a size the CPU
runs in seconds, for the tests. The cell is added as a later change
would add one: a configuration file, a traffic file and two entries in
``BENCHMARK.json``, with no file of the harness edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "tiny.closed-c4x50"


def tiny_config(base: str = "sift1m-ivf1024-flat") -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{base}.json").read_text())
    cfg.update(name="tiny-ivf32-flat", n_base=4000, dim=16, nlist=32, nprobe=4, k=5)
    cfg["assumed"].update(mixture={"components": 40, "spread": 0.25},
                          centroids={"subsample": 2000, "lloyd_iters": 2},
                          executor={"chunk": 64, "qb_buckets": [100], "d_blocks": 1},
                          scheduler={"max_batch": 100, "max_wait_s": 0.5})
    return cfg


def tiny_traffic() -> dict:
    tr = json.loads((ROOT / "perfbench" / "traffic" / "uniform-c16x1000.json").read_text())
    tr.update(clients=4, queries_per_request=50, warmup_batches=2)
    return tr


def make_copy(dest: Path, **sizes) -> Path:
    """Copy ``BENCHMARK.json`` and ``perfbench/`` to ``dest`` and add the
    tiny cell there, its configuration changed by ``sizes``. Returns
    ``dest``."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = dict(tiny_config(), **sizes)
    (dest / "perfbench" / "configs" / "tiny-ivf32-flat.json").write_text(json.dumps(cfg))
    (dest / "perfbench" / "traffic" / "tiny-c4x50.json").write_text(json.dumps(tiny_traffic()))
    bench["configs"].append({"name": cfg["name"], "source": "a test", "reduced": [],
                             "file": "perfbench/configs/tiny-ivf32-flat.json", "why": "a test"})
    bench["workloads"].append({"name": WORKLOAD, "config": cfg["name"],
                               "traffic": "tiny-c4x50", "chips": 1, "why": "a test"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
