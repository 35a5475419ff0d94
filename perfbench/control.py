"""The control of the check that decides ``correct``, at a cell's size.

    python3 perfbench/control.py --workload <name> --seconds 10 --seeds 11 12 13

For each seed, one run of the cell as ``run.py`` makes it, with the
plain reference put in the program's place one precision below the
configuration's float32 (TF32 products on the card): the engine's
``search_batch`` answers each batch by :class:`Control` worked out
from the seed's inputs, under the cell's own front end, closed loop and
load. The harness's own check then judges the run. Prints one JSON line
a seed with ``correct`` and the numbers beside their limits; a sound
check has ``correct`` false on every seed. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def control_in_place(ref, inputs, nprobe: int, device, emulate: bool = False):
    """While the block runs, ``HarmonyServer.search_batch`` answers by the
    reference's :class:`Control` over ``inputs``, not by the program."""
    import numpy as np
    import torch
    from repro_torch.core.types import SearchResult
    from repro_torch.serve import engine

    ctl = ref.Control(inputs.x, inputs.centroids, nprobe, emulate=emulate)
    orig = engine.HarmonyServer.__dict__["search_batch"]

    def search_batch(self, queries, k, **_):
        q = torch.as_tensor(np.asarray(queries, np.float32), device=device)
        ids, sc = ctl.search(q, int(k))
        return SearchResult(ids=ids.cpu().numpy(), scores=sc.cpu().numpy())

    engine.HarmonyServer.search_batch = search_batch
    try:
        yield ctl
    finally:
        engine.HarmonyServer.search_batch = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        q for q in sys.path if Path(q or ".").resolve() != Path(here)]
    import torch

    from perfbench import gen, harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload)
    ref = harness.reference_module(ROOT, cell.config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        inputs = gen.make_inputs(cell.config, seed, dev)
        with control_in_place(ref, inputs, cell.config["nprobe"], dev):
            out = harness.run_cell(ROOT, cell, seed, args.seconds, False, dev, t0,
                                   log=lambda *a, **k: None)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "checks": out["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
