"""Model assembly for the assigned architecture pool: the serving path of
all ten architectures.

The port of ``repro.models.lm``. One generic stack covers every family:

* ``dense`` / ``moe`` / ``vlm`` / ``audio`` → transformer units
  (attention + FFN or MoE) with the per-family attention flavors (GQA,
  RoPE / M-RoPE, sliding-window local:global patterns with tail locals,
  QKV bias, softcap, bidirectional encoders). An MoE block runs
  ``models.moe.moe_ffn``: the dense path, or expert parallelism over
  ``RunCtx(mesh=VirtualMesh(data=ep))``;
* ``ssm`` → xLSTM units (mLSTM blocks with a periodic sLSTM);
* ``hybrid`` → Zamba2 units (Mamba2 blocks, then the one shared
  attention + FFN block, whose weights every unit applies).

The recurrent mixers are ``models.recurrent``'s.

Params and caches are nested dicts with the reference's keys and its
stacked ``[n_units, …]`` layout, so a tree carries across
(``params_from_reference``, ``cache_from_reference``) and either
package's checkpointer reads the other's. The reference's ``lax.scan``
over units is a Python loop over views of the stacked tensors.

Public entry points:
  init_params(cfg, seed_or_generator, device=)   → param tree
  forward(params, cfg, batch, ctx)               → (logits [B,S,V] f32, MoE aux)
  loss_fn(params, cfg, batch, ctx)               → (loss + aux term, metrics)
  prefill(params, cfg, batch, ctx)               → logits of the last position
  init_cache(cfg, batch_size, max_len, device=)  → decode state
  decode_step(params, cfg, token, pos, cache)    → (logits [B,V] f32, cache)

``forward`` takes the stacked units apart once (``torch.unbind``), so
that under autograd each stacked leaf's gradient is stacked once; with
``cfg.remat`` and a param that requires grad, each unit runs under
``torch.utils.checkpoint`` (``RunCtx.remat_policy``: ``"full"``
recomputes the unit, ``"dots"`` keeps its matrix products).

``decode_step`` writes each new key, value and ring position, and each
recurrent state once the step has read it, into the cache's tensors in
place and returns the same tree. The recurrent caches hold tuples, as the
reference's: mLSTM ``(C, n)``, sLSTM ``(c, n, h)``, Mamba2 ``(ssm,
conv)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch._arrays import tensor_from_numpy
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import recurrent as rec
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.virtual_mesh import VirtualMesh


# ---------------------------------------------------------------------------
# unit structure
# ---------------------------------------------------------------------------


def unit_layout(cfg: ModelConfig) -> Dict[str, Any]:
    """How many layers form one scanned unit, and of which kinds."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        if cfg.local_global_ratio > 0:
            unit = cfg.local_global_ratio + 1
            return {"kind": "transformer", "unit_layers": unit,
                    "n_units": cfg.num_layers // unit,
                    "locals": cfg.local_global_ratio,
                    "tail_locals": cfg.num_layers % unit}
        return {"kind": "transformer", "unit_layers": 1,
                "n_units": cfg.num_layers, "locals": 0, "tail_locals": 0}
    if cfg.family == "ssm":
        every = cfg.xlstm_slstm_every or cfg.num_layers + 1
        if cfg.xlstm_slstm_every:
            if cfg.num_layers % every:
                raise ValueError(f"{cfg.num_layers} layers are no whole number of "
                                 f"{every}-block xLSTM units")
            return {"kind": "xlstm", "unit_layers": every,
                    "n_units": cfg.num_layers // every,
                    "mlstm_per_unit": every - 1}
        return {"kind": "xlstm", "unit_layers": 1, "n_units": cfg.num_layers,
                "mlstm_per_unit": 1}
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        if not (every > 0 and cfg.num_layers % every == 0):
            raise ValueError(f"{cfg.num_layers} layers are no whole number of "
                             f"{every}-block Zamba units")
        return {"kind": "zamba", "unit_layers": every,
                "n_units": cfg.num_layers // every, "mamba_per_unit": every}
    raise ValueError(cfg.family)


def map_tree(tree, fn):
    """``fn`` applied to every leaf of a nested dict or tuple (a param or
    cache tree), the keys and tuples kept."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_tree(v, fn) for v in tree)
    return fn(tree)


def _stacked(make, n: int):
    """``n`` trees drawn by ``make()`` in turn, stacked leaf by leaf into
    [n, …] tensors. Each tree is copied in before the next is drawn, so
    the peak is the stack and one tree (a lone tree is viewed as [1, …])."""
    tree = make()
    if n == 1:
        return map_tree(tree, lambda t: t[None])
    out = map_tree(tree, lambda t: t.new_empty((n, *t.shape)))

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    for i in range(n):
        put(out, tree if i == 0 else make(), i)
        tree = None
    return out


def _at(tree, i: int):
    """The i-th slice of every leaf of a stacked tree (views)."""
    return map_tree(tree, lambda a: a[i])


def _unstack(tree) -> List[Dict[str, Any]]:
    """A stacked tree (nested dicts of [n, …] leaves) as its n slices,
    views taken by one ``torch.unbind`` per leaf. Under autograd each
    leaf's gradient is then stacked once, where n ``_at`` selects would
    each fill a zero gradient of the whole leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm_weight(cfg: ModelConfig, gen: torch.Generator) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)


def _init_block(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    blk = {"ln1": _norm_weight(cfg, gen), "attn": cm.init_attention(cfg, gen),
           "ln2": _norm_weight(cfg, gen)}
    if cfg.is_moe:
        blk["moe"] = init_moe(cfg, gen)
    else:
        blk["ffn"] = cm.init_ffn(cfg, gen)
    return blk


def _init_transformer_unit(cfg: ModelConfig, gen: torch.Generator, layout) -> Dict[str, Any]:
    if layout["locals"]:
        local = _stacked(lambda: _init_block(cfg, gen), layout["locals"])
        return {"local": local, "global": _init_block(cfg, gen)}
    return {"block": _init_block(cfg, gen)}


def _init_xlstm_unit(cfg: ModelConfig, gen: torch.Generator, layout) -> Dict[str, Any]:
    """``mlstm_per_unit`` stacked mLSTM blocks, then the sLSTM block when
    the unit has one, each a pre-norm and its mixer."""
    m = layout["mlstm_per_unit"]
    out: Dict[str, Any] = {}
    if m:
        out["mlstm"] = _stacked(
            lambda: {"ln": _norm_weight(cfg, gen), "mix": rec.init_mlstm(cfg, gen)}, m)
    if layout["unit_layers"] > m:
        out["slstm"] = {"ln": _norm_weight(cfg, gen), "mix": rec.init_slstm(cfg, gen)}
    return out


def _init_zamba_unit(cfg: ModelConfig, gen: torch.Generator, layout) -> Dict[str, Any]:
    return {"mamba": _stacked(
        lambda: {"ln": _norm_weight(cfg, gen), "mix": rec.init_mamba2(cfg, gen)},
        layout["mamba_per_unit"])}


_INIT_UNIT = {"transformer": _init_transformer_unit, "xlstm": _init_xlstm_unit,
              "zamba": _init_zamba_unit}


def init_params(cfg: ModelConfig, seed_or_generator: Union[int, torch.Generator], *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's param tree (keys, stacked shapes, dtypes), drawn as
    the reference draws it: truncated normals on [−2, 2] (dense weights
    scaled by 1/√fan_in), zero norms and biases. An int seeds a generator
    on ``device`` (CUDA by default); a generator must live on ``device``.
    On ``device="meta"`` the tree has its keys, shapes and dtypes and no
    values: nothing is drawn (the dry run's shape-only init)."""
    layout = unit_layout(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = cm.ShapeOnly()
    elif isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        if torch.device(gen.device).type != dev.type:
            raise ValueError(f"the generator is on {gen.device}, the params go to {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))
    dt = cm.dtype_of(cfg)
    params: Dict[str, Any] = {
        "embed": cm.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
    }
    init_unit = _INIT_UNIT[layout["kind"]]
    params["units"] = _stacked(lambda: init_unit(cfg, gen, layout), max(layout["n_units"], 1))
    if layout.get("tail_locals"):
        params["tail_local"] = _stacked(lambda: _init_block(cfg, gen), layout["tail_locals"])
    if cfg.family == "hybrid":
        # Zamba2's shared attention + FFN block: one copy, applied in every unit
        params["shared"] = {"ln1": _norm_weight(cfg, gen), "attn": cm.init_attention(cfg, gen),
                            "ln2": _norm_weight(cfg, gen), "ffn": cm.init_ffn(cfg, gen)}
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), 0, dt)
    return params


def params_from_reference(cfg: ModelConfig, tree, *, device: DeviceLike = None):
    """The reference's param tree (nested dicts of numpy arrays, as
    ``jax.device_get`` gives them; bf16 leaves as ``ml_dtypes`` arrays) as
    the port's tree of tensors on ``device`` (CUDA by default): the same
    keys, the stacked layout, the same dtypes and bits."""
    dev = resolve_device(device)
    return map_tree(tree, lambda a: tensor_from_numpy(a).to(dev))


def tree_from_reference(tree, *, device: DeviceLike = None):
    """Any tree of the reference's arrays (nested dicts and tuples of numpy
    arrays and scalars, as ``jax.device_get`` gives them; bf16 leaves as
    ``ml_dtypes`` arrays) as tensors on ``device`` (CUDA by default): the
    same keys, shapes, dtypes and bits. Every leaf is a copy, so the
    port's in-place writes (``decode_step``'s cache, ``train_loop``'s
    params and optimizer state) never reach the caller's arrays, which
    may share the reference's own buffers."""
    dev = resolve_device(device)
    return map_tree(tree, lambda a: tensor_from_numpy(a).to(dev, copy=True))


def cache_from_reference(cfg: ModelConfig, tree, *, device: DeviceLike = None):
    """The reference's decode cache (``init_cache``'s tree, numpy leaves;
    the recurrent states as tuples) as the port's, on ``device`` (CUDA by
    default), every leaf a copy (``tree_from_reference``): ``decode_step``
    writes the cache in place."""
    return tree_from_reference(tree, device=device)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Run options, as the reference's. ``mesh`` may be a ``VirtualMesh``,
    over whose data axis the MoE blocks run expert-parallel on one card;
    any other mesh, and ``shard_heads``, place work on a device mesh,
    which the port (one card, no sharding rules) refuses."""

    mesh: Optional[Any] = None
    unroll_chunks: bool = False
    q_chunk: int = 1024
    rec_chunk: int = 128
    n_units_override: Optional[int] = None     # 0 → skip the stack
    kv_range_chunking: bool = False
    shard_heads: bool = False
    remat_policy: str = "full"                 # full | dots (save matmul outs)

    def __post_init__(self):
        if (self.mesh is not None and not isinstance(self.mesh, VirtualMesh)) or self.shard_heads:
            raise NotImplementedError(
                "RunCtx(mesh=, shard_heads=) shard over a device mesh; the port "
                "runs on one card and has no sharding rules")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r}: 'full' or 'dots'")


def _mlp(blk, cfg: ModelConfig, h, mesh):
    """The block's FFN or MoE on its normed input: (out, aux; 0.0 for an FFN)."""
    if "ffn" in blk:
        return cm.ffn(blk["ffn"], cfg, h), 0.0
    return moe_ffn(blk["moe"], cfg, h, mesh)


def _attn_block(blk, cfg: ModelConfig, x, pos, ctx: RunCtx, *, sliding: int, causal: bool):
    """One attention + FFN/MoE block: (x, aux)."""
    h = cm.rms_norm(x, blk["ln1"], cfg.norm_eps)
    h = cm.attention(
        blk["attn"], cfg, h, pos, causal=causal, sliding_window=sliding,
        q_chunk=ctx.q_chunk, unroll_chunks=ctx.unroll_chunks,
        kv_range_chunking=ctx.kv_range_chunking and causal,
    )
    x = x + h
    h, aux = _mlp(blk, cfg, cm.rms_norm(x, blk["ln2"], cfg.norm_eps), ctx.mesh)
    return x + h, aux


def _transformer_unit_fwd(cfg, unit, x, pos, ctx: RunCtx, layout):
    """One unit: (x, its blocks' aux summed from 0 in block order)."""
    causal = not cfg.encoder_only
    aux = 0.0
    if layout["locals"]:
        for blk in _unstack(unit["local"]):
            x, a = _attn_block(blk, cfg, x, pos, ctx, sliding=cfg.sliding_window,
                               causal=causal)
            aux = aux + a
        x, a = _attn_block(unit["global"], cfg, x, pos, ctx, sliding=0, causal=causal)
        return x, aux + a
    x, a = _attn_block(unit["block"], cfg, x, pos, ctx, sliding=cfg.sliding_window,
                       causal=causal)
    return x, aux + a


def _xlstm_unit_fwd(cfg, unit, x, ctx: RunCtx):
    """One xLSTM unit: its mLSTM blocks, then its sLSTM block, each a
    pre-norm residual mixer from a zero state."""
    if "mlstm" in unit:
        for blk in _unstack(unit["mlstm"]):
            x = x + rec.mlstm_mix(blk["mix"], cfg, cm.rms_norm(x, blk["ln"], cfg.norm_eps),
                                  chunk=ctx.rec_chunk, unroll_chunks=ctx.unroll_chunks)[0]
    if "slstm" in unit:
        blk = unit["slstm"]
        x = x + rec.slstm_mix(blk["mix"], cfg, cm.rms_norm(x, blk["ln"], cfg.norm_eps))[0]
    return x


def _shared_block(cfg, shared, x, attend):
    """Zamba2's shared block on x: ``attend`` (the attention on the normed
    x), then the FFN, each a residual."""
    x = x + attend(cm.rms_norm(x, shared["ln1"], cfg.norm_eps))
    return x + cm.ffn(shared["ffn"], cfg, cm.rms_norm(x, shared["ln2"], cfg.norm_eps))


def _zamba_unit_fwd(cfg, unit, shared, x, pos, ctx: RunCtx):
    """One Zamba2 unit: its Mamba2 blocks from a zero state, then the
    shared attention + FFN block (causal attention over the sequence)."""
    for blk in _unstack(unit["mamba"]):
        x = x + rec.mamba2_mix(blk["mix"], cfg, cm.rms_norm(x, blk["ln"], cfg.norm_eps),
                               chunk=ctx.rec_chunk, unroll_chunks=ctx.unroll_chunks)[0]
    return _shared_block(cfg, shared, x, lambda h: cm.attention(
        shared["attn"], cfg, h, pos, causal=True, q_chunk=ctx.q_chunk,
        unroll_chunks=ctx.unroll_chunks, kv_range_chunking=ctx.kv_range_chunking))


# ---------------------------------------------------------------------------
# full-sequence forward (prefill-style)
# ---------------------------------------------------------------------------


def _scale_embed(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x · √d_model, the root taken in x's dtype (bf16: √5376 → 73.5)."""
    if not cfg.scale_embed:
        return x
    return x * torch.sqrt(torch.tensor(cfg.d_model, dtype=x.dtype))     # a host scalar


def _embed_in(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.frontend == "audio_frames":
        x = batch["frames"].to(cm.dtype_of(cfg))
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device)[None].expand(B, S)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _scale_embed(cfg, params["embed"][tokens])
    if cfg.rope_style == "mrope":
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(S, device=x.device)[None, None].expand(3, B, S)
        return x, pos
    return x, torch.arange(S, device=x.device)[None].expand(B, S)


def _head(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).float()


def _unit_fwd(cfg, layout, unit, shared, x, pos, ctx: RunCtx):
    """One unit of any kind: (x, its aux; 0.0 without experts)."""
    if layout["kind"] == "xlstm":
        return _xlstm_unit_fwd(cfg, unit, x, ctx), 0.0
    if layout["kind"] == "zamba":
        return _zamba_unit_fwd(cfg, unit, shared, x, pos, ctx), 0.0
    return _transformer_unit_fwd(cfg, unit, x, pos, ctx, layout)


def _save_matmuls():
    """Selective checkpointing that keeps the outputs of ``aten.mm`` /
    ``aten.addmm``, the products without batch dimensions (the reference's
    ``dots_with_no_batch_dims_saveable``), and recomputes the rest."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    aten = torch.ops.aten
    return create_selective_checkpoint_contexts([aten.mm.default, aten.addmm.default])


def _remat_unit(cfg, layout, unit, shared, x, pos, ctx: RunCtx):
    """``_unit_fwd`` under ``torch.utils.checkpoint`` (non-reentrant): the
    unit's activations are recomputed in the backward pass, all of them
    (``remat_policy="full"``) or all but the matrix products (``"dots"``).
    The recompute runs with the mesh's ``drop_log`` off, so that each
    forward pass logs its dropped slots once."""
    passes = []

    def run(x):
        c = ctx
        if passes and ctx.mesh is not None and ctx.mesh.drop_log is not None:
            c = dataclasses.replace(ctx, mesh=dataclasses.replace(ctx.mesh, drop_log=None))
        passes.append(1)
        return _unit_fwd(cfg, layout, unit, shared, x, pos, c)

    kw = {"context_fn": _save_matmuls} if ctx.remat_policy == "dots" else {}
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False, **kw)


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    return tree.requires_grad


def forward(params, cfg: ModelConfig, batch, ctx: RunCtx = RunCtx()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. ``batch``: ``tokens`` [B, S] (``positions``
    [3, B, S] for M-RoPE) or ``frames`` [B, S, D]. Returns (logits
    [B,S,V] f32, the MoE blocks' aux loss summed in the reference's
    order; 0 without experts). Units are rematerialised (``cfg.remat``)
    only when autograd records: grad mode on and a param that requires
    grad."""
    layout = unit_layout(cfg)
    x, pos = _embed_in(params, cfg, batch)
    n_units = layout["n_units"] if ctx.n_units_override is None else ctx.n_units_override
    unit_fn = _unit_fwd
    if cfg.remat and torch.is_grad_enabled() and _needs_grad(params):
        unit_fn = _remat_unit
    aux = 0.0
    if n_units > 0:
        for unit in _unstack(params["units"])[:n_units]:
            x, a = unit_fn(cfg, layout, unit, params.get("shared"), x, pos, ctx)
            aux = aux + a
    if layout.get("tail_locals") and (ctx.n_units_override is None
                                      or ctx.n_units_override > 0):
        for blk in _unstack(params["tail_local"]):
            x, a = _attn_block(blk, cfg, x, pos, ctx, sliding=cfg.sliding_window,
                               causal=not cfg.encoder_only)
            aux = aux + a
    return _head(params, cfg, x), torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: ModelConfig, batch, ctx: RunCtx = RunCtx()):
    """Causal-LM (or masked-prediction for encoders) cross-entropy: the
    mean over positions of ``logsumexp(logits) − logits[target]`` in f32,
    or its ``loss_mask``-weighted sum over ``max(Σ mask, 1)``. Returns
    (loss + ``cfg.moe.load_balance_loss`` · aux, {"loss", "aux",
    "logits_mean_abs"}); ``logits_mean_abs`` is taken off the graph, so
    autograd keeps no |logits| of its own."""
    logits, aux = forward(params, cfg, batch, ctx)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    else:
        loss = nll.mean()
    total = loss + cfg.moe.load_balance_loss * aux
    flat = logits.detach()
    mean_abs = torch.linalg.vector_norm(flat, 1) / flat.numel()
    return total, {"loss": loss, "aux": aux, "logits_mean_abs": mean_abs}


def prefill(params, cfg: ModelConfig, batch, ctx: RunCtx = RunCtx()) -> torch.Tensor:
    """Prefill = full forward; the logits of the last position [B, V]. As in
    the reference, no cache is built: ``decode_step`` fills one."""
    logits, _ = forward(params, cfg, batch, ctx)
    return logits[:, -1]


# ---------------------------------------------------------------------------
# KV-cache serving: decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Decode state for all units, on ``device`` (CUDA by default): a
    global KV of ``max_len`` positions per attention layer; for a
    local:global pattern, ring buffers of ``sliding_window`` slots for the
    local layers (and the tail locals) with their positions (−1 = empty).
    xLSTM: per unit the mLSTM states ``(C [m, B, H, hd, hd], n)`` and the
    sLSTM's ``(c, n, h)`` [B, H, hd] (n starts at 1), all f32. Zamba2: the
    Mamba2 states ``(ssm [m, B, Hm, 64, ds] f32, conv [m, B, W−1, di +
    2·ds])`` and the shared block's KV of ``max_len`` per unit."""
    layout = unit_layout(cfg)
    dev = resolve_device(device)
    n, dt = layout["n_units"], cm.dtype_of(cfg)
    KV, hd, B = cfg.num_kv_heads, cfg.head_dim, batch_size

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if layout["kind"] == "xlstm":
        H, m = cfg.num_heads, layout["mlstm_per_unit"]
        hd_i = (cfg.ssm_expand or 2) * cfg.d_model // H
        out: Dict[str, Any] = {}
        if m:
            out["mlstm"] = (zeros(n, m, B, H, hd_i, hd_i, dtype=torch.float32),
                            zeros(n, m, B, H, hd_i, dtype=torch.float32))
        if layout["unit_layers"] > m:
            hd_s = cfg.d_model // H
            out["slstm"] = (zeros(n, B, H, hd_s, dtype=torch.float32),
                            torch.ones((n, B, H, hd_s), dtype=torch.float32, device=dev),
                            zeros(n, B, H, hd_s, dtype=torch.float32))
        return out
    if layout["kind"] == "zamba":
        di, ds, m = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, layout["mamba_per_unit"]
        dh = rec.MAMBA_HEAD_DIM
        return {"mamba": (zeros(n, m, B, di // dh, dh, ds, dtype=torch.float32),
                          zeros(n, m, B, cfg.ssm_conv - 1, di + 2 * ds)),
                "shared": {"k": zeros(n, B, max_len, KV, hd),
                           "v": zeros(n, B, max_len, KV, hd)}}

    def ring(*lead):
        W = max(cfg.sliding_window, 1)
        return {"k": zeros(*lead, B, W, KV, hd), "v": zeros(*lead, B, W, KV, hd),
                "pos": torch.full((*lead, B, W), -1, dtype=torch.int32, device=dev)}

    glob = {"k": zeros(n, B, max_len, KV, hd), "v": zeros(n, B, max_len, KV, hd)}
    if not layout["locals"]:
        return {"block": glob}
    out = {"local": ring(n, layout["locals"]), "global": glob}
    if layout["tail_locals"]:
        out["tail_local"] = ring(layout["tail_locals"])
    return out


def decode_step(params, cfg: ModelConfig, token, pos, cache,
                ctx: RunCtx = RunCtx(), embeds: Optional[torch.Tensor] = None):
    """One-token decode. token [B] int (or embeds [B, D]), pos [B] int
    (or [3, B] for M-RoPE), each below the cache's ``max_len``. Returns
    (logits [B, V] f32, cache), the cache updated in place. (The
    reference's one-hot write drops a token at ``pos ≥ max_len``; the
    port's index write raises on the CPU and fails on the card.)
    ``ctx.n_units_override`` runs the first n units only (0: the head
    alone), as ``forward`` does."""
    layout = unit_layout(cfg)
    if embeds is None:
        x = _scale_embed(cfg, params["embed"][token][:, None, :])       # [B,1,D]
    else:
        x = embeds[:, None, :].to(cm.dtype_of(cfg))
    if ctx.n_units_override == 0:          # the zero-stack variant
        return _head(params, cfg, x)[:, 0], cache
    n_units = layout["n_units"] if ctx.n_units_override is None else ctx.n_units_override
    for u in range(n_units):
        cache_u = {k: _at(v, u) for k, v in cache.items() if k != "tail_local"}
        unit = _at(params["units"], u)
        if layout["kind"] == "xlstm":
            x = _xlstm_unit_decode(cfg, unit, x, cache_u)
        elif layout["kind"] == "zamba":
            x = _zamba_unit_decode(cfg, unit, params["shared"], x, pos, cache_u)
        else:
            x, _ = _transformer_unit_decode(cfg, unit, x, pos, cache_u, layout, ctx)
    for i in range(layout.get("tail_locals", 0)):
        x = _local_decode(cfg, _at(params["tail_local"], i), x, pos, cache["tail_local"], i,
                          ctx)
    return _head(params, cfg, x)[:, 0], cache


def _local_decode(cfg, blk, x, pos, ring, i, ctx: RunCtx):
    """One sliding-window layer's decode over ring ``i`` of ``ring``."""
    h = cm.rms_norm(x, blk["ln1"], cfg.norm_eps)
    x = x + _ring_attention_decode(blk["attn"], cfg, h, pos, ring["k"][i], ring["v"][i],
                                   ring["pos"][i])[0]
    return x + _mlp(blk, cfg, cm.rms_norm(x, blk["ln2"], cfg.norm_eps), ctx.mesh)[0]


def _kv_decode(cfg, blk, x, pos, kv, ctx: RunCtx, sliding_window=0):
    """One layer's decode over its KV cache ``kv``."""
    h = cm.rms_norm(x, blk["ln1"], cfg.norm_eps)
    x = x + cm.attention_decode(blk["attn"], cfg, h, pos, kv["k"], kv["v"],
                                sliding_window=sliding_window)[0]
    return x + _mlp(blk, cfg, cm.rms_norm(x, blk["ln2"], cfg.norm_eps), ctx.mesh)[0]


def _transformer_unit_decode(cfg, unit, x, pos, cache_u, layout, ctx: RunCtx):
    """One unit's decode over its cache views, written in place. Returns
    (x, cache_u)."""
    if layout["locals"]:
        for i in range(layout["locals"]):
            x = _local_decode(cfg, _at(unit["local"], i), x, pos, cache_u["local"], i, ctx)
        return _kv_decode(cfg, unit["global"], x, pos, cache_u["global"], ctx), cache_u
    return _kv_decode(cfg, unit["block"], x, pos, cache_u["block"], ctx,
                      cfg.sliding_window), cache_u


def _write_state(dst, src) -> None:
    """The new recurrent state into the cache's own tensors."""
    for d, s_ in zip(dst, src):
        d.copy_(s_)


def _xlstm_unit_decode(cfg, unit, x, cache_u):
    """One xLSTM unit at S = 1: the mixers with ``chunk=1`` from the
    cache's states, each state written back in place once read."""
    if "mlstm" in unit:
        C, n = cache_u["mlstm"]
        for i in range(C.shape[0]):
            blk = _at(unit["mlstm"], i)
            h, st = rec.mlstm_mix(blk["mix"], cfg, cm.rms_norm(x, blk["ln"], cfg.norm_eps),
                                  chunk=1, state=(C[i], n[i]))
            x = x + h
            _write_state((C[i], n[i]), st)
    if "slstm" in unit:
        blk = unit["slstm"]
        h, st = rec.slstm_mix(blk["mix"], cfg, cm.rms_norm(x, blk["ln"], cfg.norm_eps),
                              state=cache_u["slstm"])
        x = x + h
        _write_state(cache_u["slstm"], st)
    return x


def _zamba_unit_decode(cfg, unit, shared, x, pos, cache_u):
    """One Zamba2 unit at S = 1: the Mamba2 blocks with ``chunk=1``, each
    state written back in place once read, then the shared block over the
    unit's own KV cache."""
    ssm, conv = cache_u["mamba"]
    for i in range(ssm.shape[0]):
        blk = _at(unit["mamba"], i)
        h, st = rec.mamba2_mix(blk["mix"], cfg, cm.rms_norm(x, blk["ln"], cfg.norm_eps),
                               chunk=1, state=(ssm[i], conv[i]))
        x = x + h
        _write_state((ssm[i], conv[i]), st)
    kv = cache_u["shared"]
    return _shared_block(cfg, shared, x, lambda h: cm.attention_decode(
        shared["attn"], cfg, h, pos, kv["k"], kv["v"])[0])


def _ring_attention_decode(p, cfg, x, pos, k_cache, v_cache, pos_cache):
    """Sliding-window decode with a ring-buffer cache [B, W, KV, hd]: the
    token goes to slot ``pos % W`` (its position into ``pos_cache``), in
    place; a slot is attended while ``0 ≤ p ≤ pos`` and ``pos − p <
    sliding_window``. Returns (out [B,1,D], k', v', pos'), the caches
    themselves."""
    B = x.shape[0]
    W = k_cache.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = cm._qkv(p, cfg, x)
    if cfg.rope_style == "rope":
        q = cm.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = cm.apply_rope(k, pos[:, None], cfg.rope_theta)
    slot = pos % W
    cm._write_slot(k_cache, slot, k[:, 0])
    cm._write_slot(v_cache, slot, v[:, 0])
    cm._write_slot(pos_cache, slot, pos.to(pos_cache.dtype))
    kk = cm._repeat_kv(k_cache, H // KV)
    vv = cm._repeat_kv(v_cache, H // KV)
    p2 = pos_cache
    m = (p2 >= 0) & (p2 <= pos[:, None]) & (pos[:, None] - p2 < cfg.sliding_window)
    out = cm._attend_dense(q, kk, vv, m[:, None, :], cfg.attn_logit_softcap)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, k_cache, v_cache, pos_cache
