"""Roofline analysis from the dry-run cache, on one NVIDIA H100 SXM.

Per (arch × shape × mesh) this derives the three roofline terms on the
card's data-sheet rates and names the dominant one:

    compute    = FLOPs_dev / peak              (989 TFLOP/s bf16; the ring: 67 fp32)
    memory     = bytes_dev / HBM_BW            (3.35 TB/s)
    collective = wire_bytes_dev / NVLINK_BW    (450 GB/s a direction)

The cache has the reference's cell schema (``repro.launch.dryrun``), so
either package's roofline reads either's cache. A reference cell's totals
are combined from its ``full`` (one unit) and ``zero`` (no unit)
variants (total = zero + n_units × unit; gemma's tail layers apportioned
by layer count); a port cell carries its whole stack's exact totals
(``stack``), which this roofline reads instead (the combination misses
Gemma3's decode and train, whose local, global and tail layers cost
unlike). Collective wire bytes apply ring factors to
result bytes (``launch.hlo``); a cell with no collective record (the
production meshes' LM cells: the port has no SPMD partitioner) gets no
collective term. xLSTM's per-timestep sLSTM recurrence is counted
analytically (``_slstm_correction``), as the reference's roofline does.

MODEL_FLOPS: 6·N·D (train) / 2·N·D (prefill/decode tokens), N = params
excluding the embedding table (MoE: active experts only); the ratio
MODEL_FLOPS / FLOPs measures how much of the counted compute is useful.

The card's bounds that ``chip_smoke.py`` holds its measurements against
live here too, so the bounds and the roofline are one code:
:func:`bound_ms`, the three kernels' per-launch byte and operation counts
(:func:`distance_launch`, :func:`int8_distance_launch`,
:func:`topk_launch`), and the LM's (:func:`lm_bounds`,
:func:`recurrent_f32_flops`, :func:`prefill_bound`,
:func:`decode_bound`, :func:`train_step_bound`).

Usage: python -m repro_torch.launch.roofline [--json build/dryrun_torch.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import re
from pathlib import Path

import numpy as np

# NVIDIA H100 SXM5 80GB data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
FP32_FLOPS = 67e12         # fp32 FLOP/s outside the tensor cores
INT8_OPS = 1979e12         # dense int8 tensor-core OP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s a direction
HBM_BYTES = 80e9           # 80 GB
PEAK_FLOPS = BF16_FLOPS    # the LM cells' compute roof
_RING_F = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}
_N_DEVICES = {"h100x1": 1}
DEFAULT_JSON = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch.json"


def custom_shape(kind: str, batch: int, seq: int):
    """A cell shape beside the assigned four (a ``ShapeSpec`` named
    ``{kind}_b{batch}_s{seq}``, which :func:`shape_named` reads back)."""
    from repro_torch.config import ShapeSpec

    return ShapeSpec(f"{kind}_b{batch}_s{seq}", seq, batch, kind)


def shape_named(name: str):
    """An assigned shape by name, or a :func:`custom_shape`'s."""
    from repro_torch.config import shape_by_name

    m = re.fullmatch(r"(train|prefill|decode)_b(\d+)_s(\d+)", name)
    return custom_shape(m[1], int(m[2]), int(m[3])) if m else shape_by_name(name)


def _n_shards(mesh_name: str) -> int:
    if mesh_name in _N_DEVICES:
        return _N_DEVICES[mesh_name]
    return 512 if mesh_name.startswith("2pod") else 256


def _wire(coll: dict, groups: int = 16) -> float:
    f = (groups - 1) / groups
    total = 0.0
    for kind, b in coll.items():
        scale = _RING_F.get(kind, 1.0)
        total += (scale * f if kind != "collective-permute" else 1.0) * b
    return total


def _combine(cell: dict, key_path) -> float:
    """total = zero + n_units·unit (+ tail share)."""
    full = cell["variants"]["full"]
    zero = cell["variants"].get("zero")
    get = lambda v: key_path(v) if v else 0.0
    if zero is None:
        return get(full)
    n = cell.get("n_units", 1)
    ul = cell.get("unit_layers", 1)
    tl = cell.get("tail_locals", 0)
    delta = get(full) - get(zero)
    if tl:
        unit = delta * ul / (ul + tl)
        tail = delta - unit
        return get(zero) + n * unit + tail
    return get(zero) + n * delta


def _combine_coll(cell: dict) -> dict:
    full = cell["variants"]["full"].get("collective_result_bytes", {})
    zero = (cell["variants"].get("zero") or {}).get("collective_result_bytes", {})
    n = cell.get("n_units", 1)
    ul, tl = cell.get("unit_layers", 1), cell.get("tail_locals", 0)
    out = {}
    for k in set(full) | set(zero):
        delta = full.get(k, 0) - zero.get(k, 0)
        if tl:
            unit = delta * ul / (ul + tl)
            out[k] = zero.get(k, 0) + n * unit + (delta - unit)
        else:
            out[k] = zero.get(k, 0) + n * delta
    return out


@functools.lru_cache(maxsize=None)
def _active_params(arch: str) -> float:
    """Params that multiply a token (the embedding table is a lookup; an
    MoE expert counts at experts_per_token / num_experts), from the
    shape-only init."""
    from repro_torch import configs as cfgs
    from repro_torch.models import init_params

    cfg = cfgs.get_config(arch)
    active = 0.0
    for names, leaf in named_leaves(init_params(cfg, 0, device="meta"), full=True):
        path = names.split("/")[1:]
        n = int(np.prod(leaf.shape))
        if path[-1] == "embed":
            continue
        if "moe" in path and path[-1] in ("w1", "w2", "w3"):
            active += n * cfg.moe.experts_per_token / cfg.moe.num_experts
        else:
            active += n
    return active


def _model_flops(arch: str, shape_name: str, kind: str, n_devices: int):
    """Analytic 6·N·D / 2·N·D (global, then per device)."""
    shape = shape_named(shape_name)
    active = _active_params(arch)
    if kind == "train":
        g = 6.0 * active * shape.global_batch * shape.seq_len
    elif kind == "prefill":
        g = 2.0 * active * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        g = 2.0 * active * shape.global_batch
    return g, g / n_devices


def _slstm_correction(arch: str, shape_name: str, kind: str, n_devices: int) -> float:
    """Per-device analytic flops of the sLSTM per-timestep recurrence,
    which the dry run does not step (``h · r`` a token and layer; × 3 for
    a train step's forward and backward)."""
    from repro_torch import configs as cfgs

    cfg = cfgs.get_config(arch)
    if cfg.family != "ssm" or not cfg.xlstm_slstm_every or kind == "decode":
        return 0.0
    shape = shape_named(shape_name)
    n_slstm = cfg.num_layers // cfg.xlstm_slstm_every
    H = cfg.num_heads
    hd = cfg.d_model // H
    per_step = 2.0 * H * hd * 4 * hd          # recurrent product per token
    g = n_slstm * shape.global_batch * shape.seq_len * per_step
    if kind == "train":
        g *= 3
    return g / n_devices


def analyze(cells, mesh_filter=None):
    rows = []
    for cell in cells:
        if not cell.get("ok") or "full" not in cell.get("variants", {}):
            continue
        if mesh_filter and cell["mesh"] != mesh_filter:
            continue
        ndev = _n_shards(cell["mesh"])
        arch, shape, kind = cell["arch"], cell["shape"], cell.get("kind", "serve")
        full = cell["variants"]["full"]
        has_coll = "collective_result_bytes" in full

        if arch == "harmony-anns":
            # per-trip counts × (chunk × ring) trips
            trips = full["inner_trips"]["chunks"] * full["inner_trips"]["ring"]
            flops = full["flops"] * trips
            bytes_ = full["bytes_accessed"] * trips
            coll = {k: b * trips for k, b in full.get("collective_result_bytes", {}).items()}
            # model flops: every (query-group pair × dim) scored once per
            # device across the ring: 2 · QG · cap · D
            # (a card running a whole virtual mesh does all its devices')
            sc = cell.get("scfg", {})
            qg = sc.get("qb", 1024) // sc.get("d_blocks", 16)
            model_dev = (2.0 * qg * sc.get("cap", 0) * sc.get("dim", 128)
                         * sc.get("virtual_devices", 1))
            model_g = model_dev * ndev
            correction = 0.0
            peak = FP32_FLOPS          # the ring's distance work is f32, TF32 off
        else:
            # the port's cells carry the whole stack's exact totals; the
            # reference's are combined from their variants
            stack = cell.get("stack")
            flops = stack["flops"] if stack else _combine(cell, lambda v: v["flops"])
            bytes_ = (stack["bytes_accessed"] if stack
                      else _combine(cell, lambda v: v["bytes_accessed"]))
            coll = _combine_coll(cell)
            correction = _slstm_correction(arch, shape, kind, ndev)
            flops += correction
            model_g, model_dev = _model_flops(arch, shape, kind, ndev)
            peak = PEAK_FLOPS

        compute_s = flops / peak
        memory_s = bytes_ / HBM_BW
        wire = _wire(coll) if has_coll else None
        collective_s = wire / NVLINK_BW if has_coll else None
        terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
        dominant = max((k for k in terms if terms[k] is not None), key=terms.get)
        mem = full.get("memory", {})
        resident = mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)
        # lower bound on HBM traffic: compulsory argument + output bytes
        # (the counted bytes above are the unfused upper bound)
        memory_lower_s = (mem.get("argument_bytes", 0) + mem.get("output_bytes", 0)) / HBM_BW
        rows.append({
            "arch": arch, "shape": shape, "mesh": cell["mesh"], "kind": kind,
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "hlo_flops_dev": flops, "hlo_bytes_dev": bytes_,
            "wire_bytes_dev": wire,
            "memory_lower_s": memory_lower_s,
            "model_flops_global": model_g,
            "model_flops_ratio": (model_dev / flops) if flops and model_dev == model_dev else 0.0,
            "slstm_correction_dev": correction,
            "resident_bytes_dev": resident,
            "fits_hbm": bool(resident <= HBM_BYTES),
            "roofline_fraction": (model_dev / peak) / max(terms[dominant], 1e-30),
        })
        if "bound" in cell:
            rows[-1]["bound_ms"] = cell["bound"]["bound_ms"]
    return rows


RECOMMEND = {
    "compute": "compute-bound: keep the tensor cores fed (bf16 GEMMs at larger "
               "tiles, fewer remat recomputes, attention off f32) or accept: "
               "this is the good roof",
    "memory": "HBM-bound: cut bytes a step: fuse elementwise chains and casts, "
              "shrink activation dtypes, avoid materialised logits and one-hots",
    "collective": "NVLink-bound: reshard to cut cross-card traffic (fewer "
                  "dimension blocks or more vector shards, overlap the ring's "
                  "hand-offs with compute)",
}


# ---------------------------------------------------------------------------
# the card's bounds (chip_smoke.py's measurements are held against these)
# ---------------------------------------------------------------------------


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM's rate
    and the f32 FLOPs plus int8 operations over theirs."""
    tb = nbytes / HBM_BW
    tf = flops / FP32_FLOPS + int8_ops / INT8_OPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def distance_launch(m: int, n: int, d: int, alive_tiles: int, row_bytes: int = 4,
                    tile: int = 128):
    """(bytes, f32 FLOPs) of one ``partial_distance_update`` launch on
    rows [n, d] (``row_bytes`` 4 for f32 rows, 2 for bf16) and queries
    [m, d]: each input read once (rows, their norms, queries, norms, acc,
    τ), acc and the skip map written once; a product of 2 · d FLOPs for
    each pair of an alive tile × tile tile, and 4 a pair for the sums."""
    nbytes = row_bytes * n * d + 4 * (n + m * d + m + 2 * m * n + m) + 4 * 2
    return nbytes, 2 * min(m, tile) * tile * d * alive_tiles + 4 * m * n


def int8_distance_launch(m: int, n: int, d: int, alive_tiles: int, tile: int = 128):
    """(bytes, f32 FLOPs, int8 operations) of one
    ``int8_partial_distance_update`` launch: codes [n, d] and [m, d] one
    byte each, the f32 norms, acc and τ, s² and the skip map."""
    nbytes = n * d + m * d + 4 * (n + 2 * m + 2 * m * n) + 4
    return nbytes, 4 * m * n, 2 * min(m, tile) * tile * d * alive_tiles


def topk_launch(m: int, c: int, k: int):
    """(bytes, operations) of one ``running_topk_update`` call merging
    [m, c] candidates (one broadcast ids row) into a [m, k] list: each
    input read and each output written once; each list entry and
    candidate compared at least once."""
    return 4 * (m * c + c + 2 * m * k) + 4 * 2 * m * k, m * (k + c)


def named_leaves(tree, name="", full=False):
    """(key, leaf) pairs of a nested dict; a tuple's leaves under its key.
    With ``full``, a key is the leaf's whole path, each step after a
    ``/``."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in named_leaves(v, f"{name}/{k}" if full else k, full)]
    if isinstance(tree, tuple):
        return [kv for v in tree for kv in named_leaves(v, name, full)]
    return [(name, tree)]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))


def lm_bounds(cfg, params, B, S, attended, expert_rows=None, state_bytes=0):
    """(prefill FLOPs of the GEMMs and attention, decode bytes read per step
    at ``attended`` positions): 2 · N · tokens over the weights that
    multiply (the embedding table is a lookup unless it is the tied head)
    plus the causal attention's QK^T and PV over the positions each query
    attends; a decode step reads those weights once, B embedding rows, and
    the attended keys and values of every attention layer. An MoE config's
    expert weights multiply ``expert_rows`` rows a layer, summed over its
    experts: B · S · E on the dense path (every expert for every token, the
    default), E · cap_e on the EP path, B · S · k for the routed slots
    alone; its router multiplies every token. The recurrent layouts:
    attention runs in every transformer layer, in each Zamba2 unit (the
    shared block, whose weights multiply once a unit and are read once a
    step), in no xLSTM layer; sLSTM's ``r`` and Mamba2's ``conv`` work in
    f32 and are counted by ``recurrent_f32_flops``; a decode step reads and
    writes the recurrent state (``state_bytes``) once. ``params`` may be
    the ``meta`` init: only shapes are read."""
    from repro_torch.models import unit_layout

    layout = unit_layout(cfg)
    units = [kv for k in ("units", "tail_local") if k in params
             for kv in named_leaves(params[k])]
    shared = named_leaves(params["shared"]) if "shared" in params else []
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    experts = {"w1", "w2", "w3"} if cfg.is_moe else set()

    def multiplying(leaves):
        return sum(t.numel() for k, t in leaves
                   if (k.startswith("w") and k not in experts) or k == "router")

    n_mm = multiplying(units) + layout["n_units"] * multiplying(shared) + head.numel()
    E = max(cfg.moe.num_experts, 1)
    per_expert = sum(t.numel() for k, t in units if k in experts) / E    # all layers
    rows = B * S * E if expert_rows is None else expert_rows
    weights = [t for _, t in units + shared]
    layers = {"transformer": cfg.num_layers, "zamba": layout["n_units"],
              "xlstm": 0}[layout["kind"]]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_flops = layers * 4 * B * H * hd * S * (S + 1) / 2
    weight_bytes = sum(t.numel() * t.element_size() for t in weights) + (
        head.numel() * head.element_size())
    embed_rows = 0 if cfg.tie_embeddings else B * cfg.d_model * params["embed"].element_size()
    kv_bytes = layers * 2 * B * attended * KV * hd * params["embed"].element_size()
    return (2 * n_mm * B * S + 2 * per_expert * rows + attn_flops,
            weight_bytes + embed_rows + kv_bytes + 2 * state_bytes)


def recurrent_f32_flops(cfg, B, S, chunk):
    """The f32 work of a recurrent prefill of B × S tokens in chunks of
    ``chunk``: per mLSTM layer the chunk bodies' products (q·kᵀ, its
    weighted sums over v and k: 6 · B · H · S · c · hd; the state read by q
    and rewritten: 4 · B · H · S · hd²) and per sLSTM layer h · r (2 · B ·
    S · d · 4 · hd); per Mamba2 layer the SSD chunk's C · Bᵀ, its sum over
    x and the state's read and rewrite (2 · B · S · c · (ds + Hm · dh) +
    4 · B · Hm · S · dh · ds) and the causal conv (2 · B · S · W · (di +
    2 · ds)); 0 for a transformer."""
    from repro_torch.models import unit_layout

    layout = unit_layout(cfg)
    c, d = min(chunk, S), cfg.d_model
    if layout["kind"] == "xlstm":
        H, m = cfg.num_heads, layout["mlstm_per_unit"]
        hd = (cfg.ssm_expand or 2) * d // H
        mlstm = 6 * B * H * S * c * hd + 4 * B * H * S * hd * hd
        slstm = 2 * B * S * d * 4 * (d // H) if layout["unit_layers"] > m else 0
        return layout["n_units"] * (m * mlstm + slstm)
    if layout["kind"] == "zamba":
        di, ds = cfg.ssm_expand * d, cfg.ssm_state
        Hm, dh = di // 64, 64
        ssd = 2 * B * S * c * (ds + Hm * dh) + 4 * B * Hm * S * dh * ds
        conv = 2 * B * S * cfg.ssm_conv * (di + 2 * ds)
        return layout["n_units"] * layout["mamba_per_unit"] * (ssd + conv)
    return 0


def prefill_bound(cfg, params, B, S, rec_chunk):
    """A prefill of B × S tokens: its GEMM and attention FLOPs at the bf16
    rate plus the recurrent f32 work at the fp32 rate, or the weights
    read once, whichever is longer."""
    flops, _ = lm_bounds(cfg, params, B, S, 0)          # the dense path: every expert
    f32_flops = recurrent_f32_flops(cfg, B, S, rec_chunk)
    ops_s = flops / BF16_FLOPS + f32_flops / FP32_FLOPS
    bytes_s = tree_bytes(params) / HBM_BW
    return dict(flops=flops, f32_flops=f32_flops, bound_ms=max(ops_s, bytes_s) * 1e3,
                bound_by="operations" if ops_s >= bytes_s else "bytes")


def decode_bound(cfg, params, B, attended, state_bytes=0):
    """A decode step at ``attended`` positions: its bytes read (and the
    recurrent state written) over HBM's rate."""
    _, step_bytes = lm_bounds(cfg, params, B, 0, attended, state_bytes=state_bytes)
    return dict(bytes=step_bytes, bound_ms=step_bytes / HBM_BW * 1e3, bound_by="bytes")


def train_step_bound(cfg, params, B, S):
    """A train step of B × S tokens with AdamW: 4 × the prefill FLOPs of
    ``lm_bounds`` (forward, the remat's recompute, a backward of 2×) at
    the bf16 rate, plus the optimizer's bytes at HBM's (params and
    gradients read, the gradients twice, μ and ν read and written, params
    written)."""
    flops, _ = lm_bounds(cfg, params, B, S, 0)
    param_bytes = grad_bytes = tree_bytes(params)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    opt_traffic = 2 * param_bytes + 2 * grad_bytes + 2 * 2 * 4 * n_params
    return dict(flops=4 * flops, optimizer_bytes=opt_traffic,
                bound_ms=(4 * flops / BF16_FLOPS + opt_traffic / HBM_BW) * 1e3,
                bound_gemm_ms=4 * flops / BF16_FLOPS * 1e3,
                bound_optimizer_ms=opt_traffic / HBM_BW * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="the dry run's cache (either package's schema)")
    ap.add_argument("--out", default=None,
                    help="rows as JSON (default: roofline_torch.json beside --json)")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    cells = json.loads(Path(args.json).read_text())
    rows = analyze(cells, args.mesh)
    out = Path(args.out) if args.out else Path(args.json).with_name("roofline_torch.json")
    out.write_text(json.dumps(rows, indent=1))

    hdr = (f"{'arch':<18} {'shape':<12} {'mesh':<12} {'comp_s':>9} {'mem_s':>9} "
           f"{'coll_s':>9} {'bound':<10} {'MF/HLO':>6} {'fit':>4}")
    print(hdr)
    print("-" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        coll = "-" if r["collective_s"] is None else f"{r['collective_s']:.3g}"
        print(f"{r['arch']:<18} {r['shape']:<12} {r['mesh']:<12} "
              f"{r['compute_s']:>9.3g} {r['memory_s']:>9.3g} "
              f"{coll:>9} {r['dominant']:<10} "
              f"{r['model_flops_ratio']:>6.2f} {'ok' if r['fits_hbm'] else 'OOM':>4}")
    print(f"\n{len(rows)} rows → {out}")


if __name__ == "__main__":
    main()
