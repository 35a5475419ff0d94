"""Optimizers over param trees: AdamW (f32 state) and Adafactor (factored
second moment — the only state that fits for the 1T-param arch).

The port of ``repro.train.optimizer``, in the same arithmetic. Trees are
nested dicts of tensors (the params' layout); the state is plain dicts
so the checkpointer treats it like params, with the reference's keys:
``step`` (a 0-d int32 tensor), ``mu`` / ``nu`` or ``v`` (per leaf
``{"vr", "vc"}`` when factored, else ``{"v"}``), and ``gnorm``. The state
is allocated beside each param, on its device.

``opt_update`` is functional, as the reference's: the caller's trees are
left as they were. ``opt_update_`` runs the same per-leaf arithmetic in
place (params, moments, ``step`` and ``gnorm`` overwritten), AdamW in
slices of ``INPLACE_CHUNK`` elements, so a step needs no second copy of
the params and moments (``train_loop`` owns its state and steps so).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

INPLACE_CHUNK = 1 << 25     # AdamW elements a slice in place (128 MiB of f32)


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    min_dim_factored: int = 128    # factor 2nd moment only for big matrices
    eps_af: float = 1e-30


def _leaves(tree) -> List[Any]:
    """The leaves of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _leaves_up_to(like, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``like``."""
    if isinstance(like, dict):
        return [sub for k, v in like.items() for sub in _leaves_up_to(v, tree[k])]
    return [tree]


def _map(like, fn: Callable, *trees):
    """``fn`` over ``like``'s leaves (and the subtrees of ``trees`` at the
    same positions), in ``like``'s structure."""
    if isinstance(like, dict):
        return {k: _map(v, fn, *(t[k] for t in trees)) for k, v in like.items()}
    return fn(like, *trees)


def _factored(p, ocfg: OptConfig) -> bool:
    return p.ndim >= 2 and min(p.shape[-2:]) >= ocfg.min_dim_factored


def init_opt_state(params, ocfg: OptConfig) -> Dict[str, Any]:
    """Zero state for ``ocfg.name``, each leaf on its param's device; ``step``
    and ``gnorm`` on the first param's."""
    dev = _leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    gnorm = torch.zeros((), dtype=torch.float32, device=dev)

    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    if ocfg.name == "adamw":
        return {"step": step, "mu": _map(params, lambda p: zeros(p.shape, p)),
                "nu": _map(params, lambda p: zeros(p.shape, p)), "gnorm": gnorm}
    if ocfg.name == "adafactor":
        def factored_state(p):
            if _factored(p, ocfg):
                return {"vr": zeros(p.shape[:-1], p),                      # row stats
                        "vc": zeros(p.shape[:-2] + p.shape[-1:], p)}       # col stats
            return {"v": zeros(p.shape, p)}
        return {"step": step, "v": _map(params, factored_state), "gnorm": gnorm}
    raise ValueError(ocfg.name)


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of each leaf's f32 sum of squares), a 0-d f32."""
    sums = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)), a true f32 quotient (a Python
    float over a tensor would be a reciprocal and a product)."""
    num = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The clipped gradient, rounded back to the gradient's dtype."""
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``_clip_scale`` in f32 and rounded back to their
    dtype, the global norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(grads, lambda g: _clipped(g, scale)), norm


def _adamw_leaf(p, g, mu, nu, ocfg: OptConfig, bc1, bc2, decay: bool):
    """One AdamW update of a leaf (or a slice of it): (p', mu', nu').
    ``decay`` is the whole leaf's ``ndim >= 2``."""
    gf = g.float()
    mu2 = ocfg.b1 * mu + (1 - ocfg.b1) * gf
    nu2 = ocfg.b2 * nu + (1 - ocfg.b2) * gf * gf
    update = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + ocfg.eps)
    if decay:
        update = update + ocfg.weight_decay * p.float()
    return (p.float() - ocfg.lr * update).to(p.dtype), mu2, nu2


def _adafactor_leaf(p, g, v, ocfg: OptConfig):
    """One Adafactor update of a whole leaf: (p', v'). The update's RMS
    clip runs over the whole (stacked) leaf."""
    gf = g.float()
    g2 = gf * gf + ocfg.eps_af
    if _factored(p, ocfg):
        vr = 0.999 * v["vr"] + 0.001 * torch.mean(g2, dim=-1)
        vc = 0.999 * v["vc"] + 0.001 * torch.mean(g2, dim=-2)
        r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=ocfg.eps_af)
        precond = (torch.rsqrt(torch.clamp(r, min=ocfg.eps_af))[..., None]
                   * torch.rsqrt(torch.clamp(vc, min=ocfg.eps_af))[..., None, :])
        update = gf * precond
        v2 = {"vr": vr, "vc": vc}
    else:
        vv = 0.999 * v["v"] + 0.001 * g2
        update = gf * torch.rsqrt(torch.clamp(vv, min=ocfg.eps_af))
        v2 = {"v": vv}
    # RMS-clip the update (standard adafactor, d=1.0)
    rms = torch.sqrt(torch.mean(update * update) + 1e-30)
    update = update / torch.clamp(rms, min=1.0)
    p2 = p.float() - ocfg.lr * update
    if p.ndim >= 2:
        p2 = p2 - ocfg.lr * ocfg.weight_decay * p.float()
    return p2.to(p.dtype), v2


def _slices(*ts: torch.Tensor):
    """Matching flat slices of at most INPLACE_CHUNK elements of
    same-shaped tensors (the whole tensors when one is not contiguous)."""
    if not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for lo in range(0, ts[0].numel(), INPLACE_CHUNK):
        yield tuple(f[lo:lo + INPLACE_CHUNK] for f in flat)


@torch.no_grad()
def opt_update_(params, grads, state, ocfg: OptConfig) -> Dict[str, Any]:
    """One optimizer step in place: ``params`` and ``state`` (moments,
    ``step``, ``gnorm``) are overwritten with the values ``opt_update``
    returns. Returns ``state``."""
    leaves_p = _leaves(params)
    leaves_g = _leaves_up_to(params, grads)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, ocfg.grad_clip)
    state["step"].add_(1)
    state["gnorm"].copy_(gnorm)
    if ocfg.name == "adamw":
        t = state["step"].float()
        bc1 = 1.0 - torch.pow(ocfg.b1, t)
        bc2 = 1.0 - torch.pow(ocfg.b2, t)
        for p, g, mu, nu in zip(leaves_p, leaves_g, _leaves_up_to(params, state["mu"]),
                                _leaves_up_to(params, state["nu"])):
            for ps, gs, ms, ns in _slices(p, g, mu, nu):
                p2, mu2, nu2 = _adamw_leaf(ps, _clipped(gs, scale), ms, ns, ocfg, bc1, bc2,
                                           decay=p.ndim >= 2)
                ps.copy_(p2)
                ms.copy_(mu2)
                ns.copy_(nu2)
        return state
    if ocfg.name != "adafactor":
        raise ValueError(ocfg.name)
    for p, g, v in zip(leaves_p, leaves_g, _leaves_up_to(params, state["v"])):
        p2, v2 = _adafactor_leaf(p, _clipped(g, scale), v, ocfg)
        p.copy_(p2)
        for k, val in v2.items():
            v[k].copy_(val)
    return state


def _copy_tree(tree):
    return _map(tree, torch.clone)


def opt_update(params, grads, state, ocfg: OptConfig) -> Tuple[Any, Dict[str, Any]]:
    """One optimizer step. Returns (new_params, new_state); the caller's
    trees are left unchanged (``opt_update_`` on copies of them)."""
    new_params, new_state = _copy_tree(params), _copy_tree(state)
    opt_update_(new_params, grads, new_state, ocfg)
    return new_params, new_state
