"""Dry run on one NVIDIA H100: every (architecture × input shape) cell
traced on ``meta`` tensors, plus the paper's own ANNS step at
billion-vector scale, with nothing allocated on any device.

Per cell and mesh this records into a JSON cache, in the reference's cell
schema (``repro.launch.dryrun``), so that either package's roofline reads
it (``python -m repro_torch.launch.roofline``):

* FLOPs, by ``torch.utils.flop_counter.FlopCounterMode`` (matrix products
  and attention: the ops it has formulas for, not the whole work);
* bytes accessed: each op's input and output bytes summed, views aside,
  through a ``TorchDispatchMode`` (the unfused upper bound, as the
  reference's CPU ``bytes accessed`` is);
* ``memory``: argument and output bytes exact from the ``meta`` trees, and
  ``temp_bytes`` as the peak of the live storages the step makes above
  its arguments (weak references to each output's storage; autograd's
  saved tensors keep theirs alive, as on the card);
* the card's bound of the cell (``roofline.prefill_bound`` /
  ``decode_bound`` / ``train_step_bound``), the code ``chip_smoke.py``
  holds its measurements against.

Each LM cell runs ``prefill``, ``decode_step`` over ``init_cache``, or the
train step (``train_loop``'s in-place step: a functional step's outputs
would be a second copy of the params and moments) on the shape-only init
(``init_params(cfg, 0, device="meta")``), with the reference's
``_ctx_for`` chunking. As the reference does, it traces a ``full``
variant (here one unit, ``n_units_override=1``; the reference's HLO
counts its scanned unit once) and a ``zero`` variant (no unit), which the
roofline combines as total = zero + n_units × unit; a third trace of the
whole stack gives the ``full`` variant's ``memory`` and the cell's exact
``stack`` totals, which the port's roofline reads (the reference's
combination by layer counts misses Gemma3's decode and train by 3–15 %:
its local, global and tail layers cost unlike). xLSTM's sLSTM is
not stepped per timestep on ``meta`` (at ``prefill_32k`` one layer alone
would take minutes of host time): its projections run, its recurrence is
counted analytically (``roofline._slstm_correction``), and the cell says
so.

Meshes: ``h100x1`` (one card, the default), and the reference's
production meshes ``pod16x16`` and ``2pod_2x16x16`` (``--mesh single |
multi | both``), never run: their cells take per-device argument bytes
from the reference's sharding rules (``sharding.rules``), FLOPs, bytes
and temp bytes as the one-card totals over the devices, and no collective
bytes, because the port has no SPMD partitioner to say what it would
send. ``run_anns_cell`` is analytic: the ring's launches from its
geometry, each launch's FLOPs and bytes from ``roofline``, its
collectives from ``hlo.ring_collectives``.

Usage:
  python -m repro_torch.launch.dryrun [--arch A]... [--shape S]... \\
      [--mesh h100x1|single|multi|both|all] [--anns | --no-anns] \\
      [--out build/dryrun_torch.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as cfgs
from repro_torch.config import ModelConfig, ShapeSpec, applicable_shapes
from repro_torch.launch import hlo, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (RunCtx, decode_step, init_cache, init_params, prefill,
                                unit_layout)
from repro_torch.models import recurrent as rec
from repro_torch.models.common import rms_norm
from repro_torch.sharding.rules import (batch_shardings, cache_shardings, opt_shardings,
                                        param_shardings, per_device_bytes)
from repro_torch.train import OptConfig, init_opt_state
from repro_torch.train.train_loop import make_inplace_train_step

MAX_UNROLL = 64          # the reference's inner-loop unroll budget
# beyond-paper options, set by --opt (the reference's shard_heads has no
# counterpart: RunCtx refuses it, the port placing nothing on a mesh)
OPT_FLAGS = {"kv_range_chunking": False, "remat_policy": "full"}
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch.json"
MESH_NAMES = {"h100x1": None, "pod16x16": False, "2pod_2x16x16": True}
META = torch.device("meta")


def _ctx_for(cfg: ModelConfig, shape: ShapeSpec, n_override):
    """The reference's chunking: q chunks of 1024 (2048 past 8K tokens),
    recurrent chunks of 256 (512), the inner loops unrolled when the cell
    has at most MAX_UNROLL of them (the port's loops are Python loops
    either way; ``unroll_chunks`` also gates ``kv_range_chunking``)."""
    q_chunk = 2048 if shape.seq_len > 8192 else 1024
    rec_chunk = 512 if shape.seq_len > 8192 else 256
    if shape.kind == "decode":
        trips = 1
    elif cfg.family in ("ssm", "hybrid"):
        trips = max(-(-shape.seq_len // q_chunk), -(-shape.seq_len // rec_chunk))
    else:
        trips = -(-shape.seq_len // q_chunk)
    unroll = trips <= MAX_UNROLL
    return RunCtx(
        unroll_chunks=unroll, q_chunk=q_chunk, rec_chunk=rec_chunk,
        n_units_override=n_override, kv_range_chunking=OPT_FLAGS["kv_range_chunking"],
        remat_policy=OPT_FLAGS["remat_policy"],
    ), {"q_chunk": q_chunk, "rec_chunk": rec_chunk, "inner_unrolled": unroll,
        "opt": dict(OPT_FLAGS),
        "inner_trips": {"q": -(-shape.seq_len // q_chunk),
                        "rec": -(-shape.seq_len // rec_chunk),
                        "effective": trips}}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaTrace(TorchDispatchMode):
    """Counts each op's input and output bytes (views aside) and the peak
    of the live storages made above the arguments; refuses any tensor
    that is not on ``meta`` but a host tensor of at most one element (the
    models' 0-d constants, such as √d_model in the embedding's dtype, and
    ``torch.utils.checkpoint``'s empty marker). A storage is live from the op that made it
    until its last tensor goes (a weak reference to the storage: views and
    autograd's saved tensors keep it)."""

    def __init__(self, arguments):
        super().__init__()
        self.bytes_accessed = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._args = {t.untyped_storage()._cdata for t in _tensors(arguments)}
        self._seen = set()

    def _release(self, key, n):
        self.live -= n
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        outs = _tensors(out)
        for t in outs:
            if t.device != META and not (t.device.type == "cpu" and t.numel() <= 1):
                raise RuntimeError(f"{func} made a tensor on {t.device}: the dry run "
                                   "runs on meta only")
        outs = [t for t in outs if t.device == META]
        if not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs
                                       if t.device == META)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._seen:
                continue
            self._seen.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._release, key, st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def _slstm_shapes_only(p, cfg: ModelConfig, x, state=None, **_):
    """``recurrent.slstm_mix`` without its per-timestep loop: the input
    and output projections and the norm run; the recurrence h_t = f(pre_t
    + h_{t−1} · r) is replaced by one elementwise op on ``pre`` that keeps
    ``r`` on the graph (so a backward reaches it), its FLOPs being
    ``roofline._slstm_correction``'s."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    pre = (x @ p["w_in"]).reshape(B, S, H, 4 * hd).float()
    h = pre[..., :hd] * p["r"][:, 0, :hd]
    y = rms_norm(h.reshape(B, S, D).to(x.dtype), p["norm"], cfg.norm_eps)
    last = h[:, -1]
    return y @ p["w_down"], (last, last, last)


@contextlib.contextmanager
def _slstm_analytic(on: bool):
    if not on:
        yield
        return
    step = rec.slstm_mix
    rec.slstm_mix = _slstm_shapes_only
    try:
        yield
    finally:
        rec.slstm_mix = step


def _batch(cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len

    def z(*s, dtype=torch.int64):
        return torch.zeros(s, dtype=dtype, device=META)

    if cfg.frontend == "audio_frames":
        return {"frames": z(B, S, cfg.d_model, dtype=torch.float32), "targets": z(B, S),
                "loss_mask": z(B, S, dtype=torch.float32)}
    out = {"tokens": z(B, S), "targets": z(B, S)}
    if cfg.rope_style == "mrope":
        out["positions"] = z(3, B, S)
    return out


def _trace(fn, arguments) -> dict:
    """Run ``fn()`` on ``meta`` under the FLOP counter and a
    :class:`MetaTrace`; the variant's entry."""
    t0 = time.perf_counter()
    arg_bytes = sum(_nbytes(t) for t in _tensors(arguments))
    with FlopCounterMode(display=False) as fc, MetaTrace(arguments) as mt:
        out = fn()
        out_bytes = sum(_nbytes(t) for t in _tensors(out)
                        if t.untyped_storage()._cdata not in mt._args)
        del out
    return {"flops": float(fc.get_total_flops()), "bytes_accessed": float(mt.bytes_accessed),
            "ops": mt.ops,
            "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                       "temp_bytes": mt.peak, "alias_bytes": 0},
            "trace_s": time.perf_counter() - t0}


def _step(cfg: ModelConfig, shape: ShapeSpec, params, ctx: RunCtx):
    """(the cell's step as a thunk, its arguments)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        ocfg = OptConfig(name=cfg.optimizer)
        opt = init_opt_state(params, ocfg)
        batch = _batch(cfg, shape)
        step = make_inplace_train_step(cfg, ocfg, ctx)
        return (lambda: step(params, opt, batch)), (params, opt, batch)
    if shape.kind == "prefill":
        batch = _batch(cfg, shape)
        batch.pop("targets")
        batch.pop("loss_mask", None)
        return (lambda: torch.no_grad()(prefill)(params, cfg, batch, ctx)), (params, batch)
    cache = init_cache(cfg, B, S, device=META)
    tok = torch.zeros((B,), dtype=torch.int64, device=META)
    pos = torch.zeros((3, B) if cfg.rope_style == "mrope" else (B,), dtype=torch.int64,
                      device=META)
    return (lambda: torch.no_grad()(decode_step)(params, cfg, tok, pos, cache, ctx)), (
        params, tok, pos, cache)


def _cell_bound(cfg, shape: ShapeSpec, params) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return roofline.train_step_bound(cfg, params, B, S)
    if shape.kind == "prefill":
        return roofline.prefill_bound(cfg, params, B, S, RunCtx().rec_chunk)
    state = sum(_nbytes(t) for k in ("mlstm", "slstm", "mamba")
                for t in _tensors(init_cache(cfg, B, S, device=META).get(k, ())))
    return roofline.decode_bound(cfg, params, B, S, state_bytes=state)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The one-card cell: ``full`` (one unit) and ``zero`` variants, the
    whole stack's memory and totals, and the card's bound."""
    layout = unit_layout(cfg)
    slstm = bool(cfg.family == "ssm" and cfg.xlstm_slstm_every and shape.kind != "decode")
    cell = {"arch": cfg.name, "shape": shape.name, "mesh": "h100x1", "kind": shape.kind,
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "n_units": layout["n_units"], "unit_layers": layout["unit_layers"],
            "tail_locals": layout.get("tail_locals", 0), "variants": {}, "ok": False}
    if slstm:
        cell["slstm"] = ("analytic: the per-timestep recurrence is not stepped; its FLOPs "
                         "are roofline._slstm_correction's, its per-step state not counted")
    params = init_params(cfg, 0, device=META)
    with _slstm_analytic(slstm):
        for variant, n in (("full", 1), ("zero", 0), ("stack", None)):
            ctx, ctx_meta = _ctx_for(cfg, shape, n)
            fn, arguments = _step(cfg, shape, params, ctx)
            entry = _trace(fn, arguments)
            entry["ctx"] = ctx_meta
            entry["collective_result_bytes"] = {}      # one card: nothing crosses
            entry["collective_counts"] = {}
            cell["variants"][variant] = entry
            print(f"    {variant}: {entry['trace_s']:.1f}s flops {entry['flops']:.4g} "
                  f"temp {entry['memory']['temp_bytes'] / 2**30:.2f} GiB", flush=True)
    stack = cell["variants"].pop("stack")
    cell["stack"] = {k: stack[k] for k in ("flops", "bytes_accessed", "ops", "trace_s")}
    cell["variants"]["full"]["memory"] = stack["memory"]
    cell["bound"] = _cell_bound(cfg, shape, params)
    cell["ok"] = True
    return cell


def on_production_mesh(cell: dict, cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool,
                       mesh_name: str) -> dict:
    """The one-card cell laid over a production mesh: per-device argument
    bytes by the reference's sharding rules; FLOPs, bytes and temp bytes
    as the totals over the devices (the whole stack's too); no collective
    record."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    ndev = roofline._n_shards(mesh_name)
    params = init_params(cfg, 0, device=META)
    args = per_device_bytes(params, param_shardings(params, cfg, mesh), mesh)
    if shape.kind == "train":
        opt = init_opt_state(params, OptConfig(name=cfg.optimizer))
        args += per_device_bytes(opt, opt_shardings(opt, params, cfg, mesh), mesh)
    if shape.kind in ("train", "prefill"):
        batch = _batch(cfg, shape)
        args += per_device_bytes(batch, batch_shardings(cfg, shape, mesh), mesh)
    else:
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
        args += per_device_bytes(cache, cache_shardings(cfg, cache, shape, mesh), mesh)
    out = json.loads(json.dumps(cell))
    out["mesh"] = mesh_name
    out["n_devices"] = ndev
    out["collectives"] = "none recorded: the port has no SPMD partitioner"
    for variant, v in out["variants"].items():
        v["flops"] /= ndev
        v["bytes_accessed"] /= ndev
        v.pop("collective_result_bytes")
        v.pop("collective_counts")
        mem = v["memory"]
        mem["temp_bytes"] //= ndev
        mem["output_bytes"] //= ndev
        if variant == "full":
            mem["argument_bytes"] = args
        else:
            mem["argument_bytes"] //= ndev
    out.pop("bound")
    for key in ("flops", "bytes_accessed"):
        out["stack"][key] /= ndev
    return out


def anns_config(multi_pod: bool):
    """The reference's SpaceV1B-scale ring (``--opt``: V = 128 × B = 2,
    bf16 rows)."""
    from repro_torch.core.pipeline import SpmdConfig

    n_pods = 2 if multi_pod else 1
    if OPT_FLAGS["kv_range_chunking"]:          # --opt
        return SpmdConfig(v_shards=128, d_blocks=2, n_pods=n_pods, qb=1024, cap=2**19,
                          dim=128, nprobe=64, k=10, chunk=2**15, x_dtype="bfloat16")
    return SpmdConfig(v_shards=16, d_blocks=16, n_pods=n_pods, qb=1024, cap=2**22, dim=128,
                      nprobe=64, k=10, chunk=2**16)


def run_anns_cell(mesh_name: str, multi_pod: bool) -> dict:
    """The paper's own workload, analytically. Per device (p, v, b) and
    step: n_chunks × B distance launches (M = QG, N = chunk, Db) and
    n_chunks top-K launches (C = chunk, K), every tile alive (no pruning:
    the upper bound); the ring's hand-offs and merges from
    ``hlo.ring_collectives``. On ``h100x1`` the card runs the whole
    P × V × B grid (its ``virtual_devices``) and nothing crosses a card.
    The cache keeps the reference's per-trip convention: a (chunk,
    stage) trip's share, × ``inner_trips`` in the roofline."""
    scfg = anns_config(multi_pod)
    P, V, B = scfg.n_pods, scfg.v_shards, scfg.d_blocks
    qg, db, chunk, n_chunks, K = scfg.qg, scfg.db, scfg.chunk, scfg.n_chunks, scfg.k
    trips = n_chunks * B
    one_card = mesh_name == "h100x1"
    devices = P * V * B if one_card else 1              # the grid devices a row covers
    tiles = -(-qg // scfg.tile_m) * -(-chunk // scfg.tile_n)
    row_bytes = 2 if scfg.x_dtype == "bfloat16" else 4
    d_bytes, d_flops = roofline.distance_launch(qg, chunk, db, tiles, row_bytes)
    t_bytes, t_ops = roofline.topk_launch(qg, chunk, K)
    stage, step = hlo.ring_collectives(scfg)
    per_trip, counts = {}, {}
    if not one_card:
        per_trip = dict(hlo.collective_bytes(stage))
        counts = {k: n * trips for k, n in hlo.count_collectives(stage).items()}
        for k, b in hlo.collective_bytes(step).items():
            per_trip[k] = per_trip.get(k, 0) + b / trips
        for k, n in hlo.count_collectives(step).items():
            counts[k] = counts.get(k, 0) + n
    cap = scfg.cap
    resident = (cap * db * row_bytes + cap * 4 * 3) * devices + scfg.qb * scfg.dim * 4
    entry = {
        "flops": devices * (d_flops + t_ops / B),
        "bytes_accessed": devices * (d_bytes + t_bytes / B),
        "collective_result_bytes": per_trip,
        "collective_counts": counts,
        "memory": {"argument_bytes": resident, "output_bytes": 2 * 4 * scfg.qb * K,
                   "temp_bytes": 2 * 4 * qg * chunk, "alias_bytes": 0},
        "inner_trips": {"chunks": n_chunks, "ring": B},
    }
    merges = int(V > 1) + int(P > 1)
    return {"arch": "harmony-anns", "shape": "spacev1b_like", "mesh": mesh_name,
            "kind": "serve", "variants": {"full": entry}, "ok": True, "analytic": True,
            "launches": {"distance": devices * n_chunks * B, "topk": devices * n_chunks,
                         "merges": merges},
            "scfg": {"cap": cap, "chunk": chunk, "qb": scfg.qb, "dim": scfg.dim,
                     "n_chunks": n_chunks, "v_shards": V, "d_blocks": B, "n_pods": P,
                     "x_dtype": scfg.x_dtype, "opt": dict(OPT_FLAGS),
                     **({"virtual_devices": devices} if one_card else {})}}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dry-run every (arch x shape) cell on meta "
                                 "tensors for one H100 (no card needed).")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["h100x1", "single", "multi", "both", "all"],
                    default="h100x1",
                    help="h100x1: one card; single / multi / both: the reference's "
                         "production meshes (described, never run); all: every one")
    ap.add_argument("--anns", action="store_true", help="only the ANNS cells")
    ap.add_argument("--no-anns", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--opt", action="store_true",
                    help="kv_range_chunking, and the ANNS ring at V=128 x B=2 on bf16 "
                         "rows; writes *_opt.json (the reference's shard_heads has no "
                         "counterpart: the port places nothing on a mesh)")
    ap.add_argument("--remat-policy", dest="remat_policy", default=None,
                    choices=["full", "dots"])
    args = ap.parse_args(argv)
    if args.opt:
        OPT_FLAGS["kv_range_chunking"] = True
    if args.remat_policy:
        OPT_FLAGS["remat_policy"] = args.remat_policy
    if args.out is None:
        args.out = str(DEFAULT_OUT.with_name(
            "dryrun_torch_opt.json" if args.opt else "dryrun_torch.json"))
    names = {"h100x1": ["h100x1"], "single": ["pod16x16"], "multi": ["2pod_2x16x16"],
             "both": ["pod16x16", "2pod_2x16x16"], "all": list(MESH_NAMES)}[args.mesh]

    out_path = Path(args.out)
    existing = {}
    if out_path.exists():
        for r in json.loads(out_path.read_text()):
            existing[(r["arch"], r["shape"], r["mesh"])] = r

    def save():
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(list(existing.values()), indent=1))

    if not args.anns:
        for arch in args.arch or cfgs.arch_names():
            cfg = cfgs.get_config(arch)
            shapes = [s for s in applicable_shapes(cfg)
                      if not args.shape or s.name in args.shape]
            for shape in shapes:
                keys = [(arch, shape.name, m) for m in names]
                if all(existing.get(k, {}).get("ok") for k in keys):
                    print(f"[skip cached] {arch} × {shape.name}")
                    continue
                print(f"[cell] {arch} × {shape.name}", flush=True)
                try:
                    one = trace_cell(cfg, shape)
                    for m in names:
                        existing[(arch, shape.name, m)] = one if m == "h100x1" else (
                            on_production_mesh(one, cfg, shape, MESH_NAMES[m], m))
                except Exception as e:
                    traceback.print_exc()
                    for m in names:
                        existing[(arch, shape.name, m)] = {
                            "arch": arch, "shape": shape.name, "mesh": m, "ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                save()

    if not args.no_anns:
        for m in names:
            print(f"[cell] harmony-anns × spacev1b_like × {m}", flush=True)
            existing[("harmony-anns", "spacev1b_like", m)] = run_anns_cell(
                m, MESH_NAMES[m] is True)
        save()

    n_ok = sum(1 for r in existing.values() if r.get("ok"))
    print(f"\ndone: {n_ok}/{len(existing)} cells ok → {out_path}")
    return 0 if n_ok == len(existing) else 1


if __name__ == "__main__":
    raise SystemExit(main())
