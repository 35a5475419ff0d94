"""Sharding rules: logical parameter name → the spec of its dimensions
over a mesh's axes.

The reference's rules, as spec logic over a mesh's ``shape`` dict (a
``VirtualMesh``, or anything with such a ``shape``). TP over ``model``;
DP (+FSDP where ``cfg.fsdp_params``) over ``data`` and ``pod``; MoE
experts over ``data`` (EP). Decode caches shard batch over (pod, data)
and KV heads over ``model`` when divisible, else the sequence axis;
batch-1 long-context cells shard the sequence axis over every mesh axis.

A spec is a tuple with one entry per dimension: ``None``, an axis name
or a tuple of names, the port's stand-in for a ``PartitionSpec`` (no
``NamedSharding``: the port runs on one card and places nothing). The
rules operate on *trailing* dims; leading unit/local stacking axes are
padded with ``None``. :func:`per_device_bytes` says what each device of
such a mesh would hold.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np

from repro_torch.config import ModelConfig, ShapeSpec

Spec = Tuple[Any, ...]


def _spec(*entries) -> Spec:
    """A spec as ``PartitionSpec`` normalises one: a one-axis tuple is
    that axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _axes_size(mesh, s) -> int:
    axes = (s,) if isinstance(s, str) else tuple(s)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _pad(spec: Sequence, ndim: int) -> Spec:
    spec = list(spec)
    if len(spec) > ndim:
        raise ValueError((spec, ndim))
    return _spec(*([None] * (ndim - len(spec)) + spec))


def _sanitize(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Drop mesh axes from dims they don't divide (the reference's jit
    in_shardings need divisible argument dims, e.g. hubert's vocab of
    504)."""
    out = []
    for dim, s in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        out.append(None if s is None or dim % _axes_size(mesh, s) else s)
    return _spec(*out)


def _base_param_spec(name: str, parent: str, cfg: ModelConfig):
    """Trailing-dims spec for one parameter leaf."""
    fsdp = "data" if cfg.fsdp_params else None
    if parent == "moe":
        if name in ("w1", "w3"):
            return ("data", None, "model")
        if name == "w2":
            return ("data", "model", None)
        if name == "router":
            return (None, None)
    if name == "embed":
        # tied embeddings double as the LM head → vocab sharded so logits
        # come out vocab-sharded; untied tables shard d_model
        return ("model", None) if cfg.tie_embeddings else (None, "model")
    if name in ("lm_head", "wq", "wk", "wv", "w1", "w3", "w_up", "w_in"):
        return (fsdp, "model")
    if name in ("wo", "w2", "w_down"):
        return ("model", fsdp)
    if name in ("bq", "bk", "bv"):
        return ("model",)
    if name == "conv":
        return (None, "model")
    if name == "r":                      # sLSTM recurrent kernel [H, hd, 4hd]
        return (None, None, "model")
    # norms, gates, scalars (ln*, norm, A_log, D, dt_bias, final_norm, w_if)
    return ()


def _map_with_path(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict or tuple, its structure kept;
    a path holds dict keys and tuple indices as strings."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_with_path(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _named_spec(names, leaf, cfg: ModelConfig, mesh, unfactored_v) -> Spec:
    """A param or optimizer-slot leaf's spec from the names on its path.
    Adafactor's factored stats (``vr``/``vc``) mirror their parameter's
    spec minus a dim; an unfactored slot ``v`` mirrors the parameter
    itself where ``unfactored_v(parent)`` says so."""
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    pname, pparent = parent, names[-3] if len(names) > 2 else ""
    nd = len(leaf.shape)
    if name in ("vr", "vc"):
        base = list(_base_param_spec(pname, pparent, cfg))
        full = [None] * (nd + 1 - len(base)) + base
        spec = full[:-1] if name == "vr" else full[:-2] + full[-1:]
        return _sanitize(spec, leaf.shape, mesh)
    if name == "v" and unfactored_v(parent):
        return _sanitize(_pad(_base_param_spec(pname, pparent, cfg), nd), leaf.shape, mesh)
    return _sanitize(_pad(_base_param_spec(name, parent, cfg), nd), leaf.shape, mesh)


def param_shardings(params_shape, cfg: ModelConfig, mesh):
    """The params' tree of specs. ``params_shape`` may be the real params
    or the ``meta`` init (``init_params(cfg, 0, device="meta")``)."""
    return _map_with_path(params_shape, lambda path, leaf: _named_spec(
        path, leaf, cfg, mesh, lambda parent: parent not in ("", "moe")))


def opt_shardings(opt_shape, params_shape, cfg: ModelConfig, mesh):
    """AdamW ``mu``/``nu`` mirror the params; Adafactor by the name rules
    above; ``step`` and ``gnorm`` replicated."""

    def leaf_spec(path, leaf):
        if path[-1] in ("step", "gnorm"):
            return ()
        return _named_spec(path, leaf, cfg, mesh, lambda parent: True)

    return _map_with_path(opt_shape, leaf_spec)


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Specs of the train/prefill input batch dict."""
    ba = batch_axes(mesh)
    bsz = _axes_size(mesh, ba)
    bspec = ba if shape.global_batch % bsz == 0 and shape.global_batch >= bsz else None
    out = {"tokens": _spec(bspec, None), "targets": _spec(bspec, None)}
    if cfg.frontend == "audio_frames":
        out = {"frames": _spec(bspec, None, None), "targets": _spec(bspec, None),
               "loss_mask": _spec(bspec, None)}
    if cfg.rope_style == "mrope":
        out["positions"] = _spec(None, bspec, None)
    return out


def cache_shardings(cfg: ModelConfig, cache_shape, shape: ShapeSpec, mesh):
    """Specs of the decode cache tree (``init_cache(..., device="meta")``)."""
    ba = batch_axes(mesh)
    bsz = _axes_size(mesh, ba)
    B = shape.global_batch
    b_ok = B % bsz == 0 and B >= bsz
    model_size = mesh.shape["model"]
    all_axes = ba + ("model",)

    def leaf_spec(path, leaf):
        name, shp = path[-1], tuple(leaf.shape)
        nd = len(shp)
        if name in ("k", "v") and nd >= 4:
            # [..., B, S, KV, hd]
            KV, S = shp[-2], shp[-3]
            if b_ok:
                bs = ba
                kv_spec = "model" if KV % model_size == 0 else None
                s_spec = None if kv_spec else ("model" if S % model_size == 0 else None)
            else:
                bs, kv_spec = None, None
                # batch-1 long context: shard the sequence over everything
                s_spec = all_axes if S % (bsz * model_size) == 0 else "model"
            return _spec(*([None] * (nd - 4) + [bs, s_spec, kv_spec, None]))
        if name == "pos" and nd >= 2:
            return _spec(*([None] * (nd - 2) + [ba if b_ok else None, None]))
        if nd >= 3:
            # recurrent states: the batch dim == B, then the largest
            # trailing dim over model if divisible
            spec = [None] * nd
            bdim = next((i for i, s in enumerate(shp) if s == B and i >= 1), None)
            if b_ok and bdim is not None:
                spec[bdim] = ba
            for i in range(nd - 1, max(nd - 3, 0), -1):
                if i != bdim and shp[i] % model_size == 0 and shp[i] >= model_size:
                    spec[i] = "model"
                    break
            return _spec(*spec)
        return ()

    return _map_with_path(cache_shape, leaf_spec)


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, ``meta`` ones too) laid
    out by ``specs`` (its tree of specs): each leaf's bytes over the
    product of the axis sizes its spec splits it by (``_sanitize`` keeps
    only splits that divide)."""
    if isinstance(tree, dict):
        return sum(per_device_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, tuple):
        return sum(per_device_bytes(v, s, mesh) for v, s in zip(tree, specs))
    split = int(np.prod([_axes_size(mesh, s) for s in specs if s is not None] or [1]))
    return tree.numel() * tree.element_size() // split
