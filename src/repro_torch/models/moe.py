"""Mixture-of-Experts FFN: routing, the one-device dense path, and expert
parallelism over a virtual data axis.

The port of ``repro.models.moe``, in the same arithmetic:

* ``_route``: f32 router logits, softmax, top-k (ties to the lower
  expert, as ``jax.lax.top_k``), gates renormalised by ``max(sum, 1e-9)``,
  the Switch load-balance aux loss ``E · Σ_e f_e · p_e``;
* ``moe_ffn_dense``: every expert for every token, then the gate weights
  (the reference's one-device path);
* ``moe_ffn_ep``: the reference's expert-parallel layer (fixed-capacity
  send buffers, one all-to-all each way, over-capacity slots dropped) on
  one card. ``VirtualMesh(data=ep)`` stands in for the device mesh: the
  ``ep`` ranks are a leading tensor dimension, so the number of torch ops
  does not grow with ``ep``.

The EP path drops only the slots past a capacity. The reference writes
each dropped slot to position ``cap_send − 1`` of its destination (and
each invalid received entry to ``buf[0, cap_e − 1]``) by a scatter with
duplicate indices, so on XLA's CPU a destination that overflows also
loses its last kept slot; the port builds its buffers by gathers and
never scatters through duplicate indices. At the default capacity the
two agree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.virtual_mesh import VirtualMesh


def _mesh_ep(mesh, data_axis: str, model_axis: str) -> int:
    if not isinstance(mesh, VirtualMesh):
        raise NotImplementedError(
            f"moe_ffn_ep over {type(mesh).__name__}: the port runs on one card; "
            "pass VirtualMesh(data=ep)")
    if data_axis != "data" or model_axis != "model":
        raise ValueError(f"a VirtualMesh has the axes data and model, not "
                         f"{data_axis!r} and {model_axis!r}")
    if mesh.model != 1:
        raise NotImplementedError(
            f"moe_ffn_ep over VirtualMesh(model={mesh.model}): the port's EP layer "
            "keeps each expert whole on its rank; pass VirtualMesh(data=ep)")
    if mesh.pod != 1:
        raise NotImplementedError(
            f"moe_ffn_ep over VirtualMesh(pod={mesh.pod}): the EP layer runs over "
            "the data axis alone; pass VirtualMesh(data=ep)")
    return mesh.shape["data"]


def _expert_init(gen: torch.Generator, shape, in_axis: int, dtype,
                 max_elems: int = 1 << 28) -> torch.Tensor:
    """``common.dense_init`` of an [E, ·, ·] expert stack, drawn in slices
    of whole experts of at most ``max_elems`` f32 values (one slice, the
    same draw as ``dense_init``, up to 1 GiB): Kimi K2's 384 experts
    would otherwise hold 22.5 GB of f32 at once per weight."""
    per_expert = shape[1] * shape[2]
    step = max(1, max_elems // per_expert)
    if step >= shape[0]:
        return cm.dense_init(gen, shape, in_axis, dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for lo in range(0, shape[0], step):
        hi = min(shape[0], lo + step)
        out[lo:hi] = cm.dense_init(gen, (hi - lo, *shape[1:]), in_axis, dtype)
    return out


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """The reference's MoE params: the router f32 [d, E] (fan-in axis 0),
    ``w1``/``w3`` [E, d, f] and ``w2`` [E, f, d] in the config's dtype
    (fan-in axis 1), drawn in that order on ``gen``'s device."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    dt = cm.dtype_of(cfg)
    return {
        "router": cm.dense_init(gen, (d, e), 0, torch.float32),
        "w1": _expert_init(gen, (e, d, f), 1, dt),
        "w3": _expert_init(gen, (e, d, f), 1, dt),
        "w2": _expert_init(gen, (e, f, d), 1, dt),
    }


def _route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor):
    """xt [..., T, D] → (gates [..., T, k] f32, experts [..., T, k] int32,
    aux [...] f32), each leading index routed on its own (a rank of the EP
    path). The top-k is a stable descending sort's first k, so equal
    probabilities go to the lower expert, as ``jax.lax.top_k`` breaks them."""
    k, e_count = cfg.moe.experts_per_token, cfg.moe.num_experts
    logits = xt.float() @ router                               # [..., T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * Σ_e (token fraction to e) * (mean prob of e)
    frac = torch.nn.functional.one_hot(top_e[..., 0], e_count).float().mean(-2)
    aux = e_count * torch.sum(frac * probs.mean(-2), dim=-1)
    return gates, top_e.to(torch.int32), aux


def _expert_ffn(cfg: ModelConfig, buf: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """buf [E_l, C, D] → [E_l, C, D] through each expert's SwiGLU, each
    product rounded to the weights' dtype. ``buf`` may be a token block
    broadcast over the experts (batch stride 0)."""
    h = cm._silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def moe_ffn_dense(p, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert for every token, then the gates (cast to the output
    dtype) over the experts: x [B, S, D] → (y [B, S, D], aux)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T, E = xt.shape[0], cfg.moe.num_experts
    gates, top_e, aux = _route(cfg, xt, p["router"])
    out_all = _expert_ffn(cfg, xt.expand(E, T, D), p["w1"], p["w3"], p["w2"])  # [E, T, D]
    comb = torch.zeros((T, E), dtype=out_all.dtype, device=x.device)
    comb.scatter_(1, top_e.long(), gates.to(out_all.dtype))   # k distinct experts a row
    out = torch.bmm(comb[:, None, :], out_all.transpose(0, 1))[:, 0]      # Σ_e comb · out
    return out.reshape(B, S, D), aux


def ep_capacities(cfg: ModelConfig, tokens_per_rank: int, ep: int,
                  capacity_factor: float = 1.5) -> Tuple[int, int]:
    """(cap_send, cap_e) of ``moe_ffn_ep``: the slots a rank sends to each
    rank, and the slots each expert computes, as the reference's Python
    float expressions give them."""
    k, e_local = cfg.moe.experts_per_token, cfg.moe.num_experts // ep
    cap_send = max(8, int(capacity_factor * tokens_per_rank * k / ep))
    return cap_send, max(8, int(capacity_factor * ep * cap_send / e_local))


def _buckets(group: torch.Tensor, n_groups: int, cap: int):
    """Entries [R, N] sorted into ``n_groups`` buckets per row, in entry
    order within a bucket (an entry with ``group == n_groups`` belongs to
    none). Returns (pos [R, N]: each entry's running count within its
    bucket; at [R, n_groups, cap]: the entry at each bucket position;
    filled [R, n_groups, cap]: whether that position has one)."""
    R, N = group.shape
    dev = group.device
    sorted_g, order = torch.sort(group, dim=1, stable=True)
    ids = torch.arange(n_groups, device=dev).expand(R, n_groups).contiguous()
    start = torch.searchsorted(sorted_g, ids)
    count = torch.searchsorted(sorted_g, ids, right=True) - start
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(N, device=dev).expand(R, N))
    pos = rank - start.gather(1, group.clamp(max=n_groups - 1))
    c = torch.arange(cap, device=dev)
    filled = c < count[..., None]
    idx = (start[..., None] + c).clamp(max=N - 1).reshape(R, n_groups * cap)
    return pos, order.gather(1, idx).reshape(R, n_groups, cap), filled


def moe_ffn_ep(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    mesh: VirtualMesh,
    *,
    capacity_factor: float = 1.5,
    data_axis: str = "data",
    model_axis: str = "model",
    pod_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel layer over ``mesh.shape["data"]``
    ranks on one card. Rank r holds batch rows [r·B/ep, (r+1)·B/ep) and
    experts [r·E/ep, (r+1)·E/ep). Each rank routes its T tokens' T·k slots
    (slot t·k + j) and numbers them by destination rank in slot order;
    those below ``cap_send`` are sent. A destination numbers what it
    receives (source-major, then send position) per local expert; those
    below ``cap_e`` are computed. A token's output is the sum of its k
    slots' expert outputs times their gates, in slot order; a dropped
    slot adds 0. aux is the mean of the ranks' ``_route`` aux.

    The all-to-alls are index arithmetic: the experts' buffer is one
    gather of token rows, the return one gather of expert rows."""
    if pod_axis is not None:
        raise ValueError("a VirtualMesh has no pod axis")
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    ep = _mesh_ep(mesh, data_axis, model_axis)
    if E % ep:
        raise ValueError(f"{E} experts are no whole number per {ep} ranks")
    B, S, D = x.shape
    if B % ep:
        raise ValueError(f"batch {B} does not split over {ep} ranks of the data axis")
    e_local, T = E // ep, (B // ep) * S
    N, dev = T * k, x.device
    xt = x.reshape(ep, T, D)
    gates, top_e, aux = _route(cfg, xt, p["router"])        # [ep, T, k] ×2, [ep]
    fe = top_e.reshape(ep, N).long()
    fg = gates.reshape(ep, N)

    # send: slot i of rank s goes to rank fe // e_local at its running count
    dest = fe // e_local
    cap_send, cap_e = ep_capacities(cfg, T, ep, capacity_factor)
    pos, sent, sent_ok = _buckets(dest, ep, cap_send)       # sent [src, dst, cap_send]
    keep = pos < cap_send

    # receive: rank d's entry j = s·cap_send + p is the slot sent[s, d, p]
    M = ep * cap_send
    local_e = torch.where(sent_ok, fe.gather(1, sent.reshape(ep, M)).reshape(sent.shape) % e_local,
                          e_local).transpose(0, 1).reshape(ep, M)
    row_of = (torch.arange(ep, device=dev)[:, None, None] * T + sent // k).transpose(0, 1)
    pos_e, entry, entry_ok = _buckets(local_e, e_local, cap_e)   # entry [dst, e_local, cap_e]

    rows = row_of.reshape(ep, M).gather(1, entry.reshape(ep, e_local * cap_e))
    buf = x.reshape(ep * T, D)[rows.reshape(-1)].reshape(E, cap_e, D)
    buf.masked_fill_(~entry_ok.reshape(E, cap_e, 1), 0)
    out_buf = _expert_ffn(cfg, buf, p["w1"], p["w3"], p["w2"])   # [E, cap_e, D]

    # return: slot i's output sits at expert fe, bucket position pos_e of its entry
    j = dest * M + torch.arange(ep, device=dev)[:, None] * cap_send + pos.clamp(max=cap_send - 1)
    pe = pos_e.reshape(-1)[j]
    ok = keep & (pe < cap_e)
    out = out_buf.reshape(E * cap_e, D)[(fe * cap_e + pe.clamp(max=cap_e - 1)).reshape(-1)]
    slot_out = (torch.where(ok.reshape(-1, 1), out, 0)
                * fg.to(x.dtype).reshape(-1, 1)).reshape(ep, T, k, D)
    y = slot_out[:, :, 0]
    for i in range(1, k):                                   # in slot order, as the scatter-add
        y = y + slot_out[:, :, i]
    if mesh.drop_log is not None:
        mesh.drop_log.append((~ok).reshape(B, S, k).sum(-1))
    return y.reshape(B, S, D), aux.mean()


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, mesh: Optional[VirtualMesh] = None,
            **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense path without a mesh or with one rank, else the EP path."""
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return moe_ffn_dense(p, cfg, x)
    return moe_ffn_ep(p, cfg, x, mesh, **kw)
