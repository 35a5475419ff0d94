"""Training launcher — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --smoke \
        --steps 20 [--ckpt-dir /tmp/ckpt] [--device cpu]

``--smoke`` selects the reduced config; without it the full config is
used. The model trains from the seeded init on the synthetic
``TokenPipeline``, on the card unless ``--device`` names another device.
Resumes automatically from the latest checkpoint in ``--ckpt-dir`` (its
params; the optimizer starts afresh, as the reference's loop does).
"""

from __future__ import annotations

import argparse

from repro_torch import configs as cfgs
from repro_torch._device import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenPipeline
from repro_torch.models import RunCtx, init_params
from repro_torch.train import OptConfig, init_opt_state, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgs.arch_names())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = cfgs.get_smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} is encoder-only/frontend-stubbed; use "
                         "its masked-prediction path via tests/models instead")
    dev = resolve_device(args.device)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch)
    params = init_params(cfg, 0, device=dev)
    ocfg = OptConfig(name=cfg.optimizer, lr=args.lr)
    ck = Checkpointer(args.ckpt_dir, keep=3, async_write=True) if args.ckpt_dir else None
    start = 0
    if ck is not None and ck.latest_step() is not None:
        target = {"params": params, "opt": init_opt_state(params, ocfg)}
        params = ck.restore(target, device=dev)["params"]
        start = ck.latest_step()
        print(f"resumed from step {start}")
    params, _, hist = train_loop(
        cfg, params, pipe, steps=args.steps, ocfg=ocfg,
        ctx=RunCtx(rec_chunk=16, q_chunk=64),
        checkpointer=ck, ckpt_every=args.ckpt_every, start_step=start,
    )
    if ck:
        ck.wait()
    print(f"final loss {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
