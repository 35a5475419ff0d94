"""ANNS serving launcher — the production entry point of the port. Builds
an index on the card (or ``--device``), starts the HarmonyServer, and
drains a synthetic request stream while reporting QPS/latency/replans.

    PYTHONPATH=src python -m repro_torch.launch.serve --nb 20000 --nodes 8 \
        --batches 16 [--fail-node 3] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.config import HarmonyConfig
from repro_torch.core import build_ivf
from repro_torch.data import make_dataset, make_queries
from repro_torch.serve import HarmonyServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nlist", type=int, default=128)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--skew", type=float, default=0.5)
    ap.add_argument("--fail-node", type=int, default=None)
    ap.add_argument("--replan-every", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)

    ds = make_dataset(nb=args.nb, dim=args.dim, n_components=max(args.nlist // 4, 8),
                      spread=0.6, seed=0)
    cfg = HarmonyConfig(dim=args.dim, nlist=args.nlist, nprobe=args.nprobe,
                        topk=args.topk)
    index = build_ivf(ds.x, cfg, device=args.device)
    srv = HarmonyServer(index, n_nodes=args.nodes, replan_every=args.replan_every,
                        device=args.device)
    print(f"plan V×B = {srv.plan.v_shards}×{srv.plan.d_blocks} on {args.nodes} "
          f"nodes, device {srv.device}")
    for i in range(args.batches):
        q = make_queries(ds, nq=args.batch_size, skew=args.skew, noise=0.2, seed=i)
        srv.search_batch(q)
        if args.fail_node is not None and i == args.batches // 2:
            print(f"killing node {args.fail_node}")
            srv.fail_node(args.fail_node)
            print(f"re-planned: V×B = {srv.plan.v_shards}×{srv.plan.d_blocks}")
    s = srv.stats
    print(f"{s.queries} queries | QPS(serial)={s.qps:.0f} | "
          f"p50={s.latency_pct(50):.1f}ms p95={s.latency_pct(95):.1f}ms | "
          f"replans={s.replans} | spmd batches={s.spmd_batches}")
    return s


if __name__ == "__main__":
    main()
