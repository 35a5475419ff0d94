"""Recurrent sequence mixers: mLSTM / sLSTM (xLSTM) and Mamba2 (Zamba2).

The port of ``repro.models.recurrent``, in the same arithmetic. Prefill
uses the chunkwise-parallel form: within a chunk of ``chunk`` steps the
quadratic masked form, across chunks a compact state carried by a Python
loop (the reference's ``lax.scan``, or its unrolled loop under
``unroll_chunks``: the two give the same values, so the port has one
loop). Decode calls the same mixers at S = 1 with ``chunk=1``.

Each chunk body runs head-major ([B, H, t, ·]), so every contraction is
one batched matrix product: the reference's three-operand einsums
(``btsh,btsh,bshd->bthd``, ``bsh,bshd,bshe->bhde``, …) become a gate
scaling and one product, never the outer product a literal reading
would hold. The pairwise decays ``exp(cum_t − cum_s)`` are taken on the
causal triangle only (the exponent is set to −inf above it), as the
reference's ``where`` keeps them: above the diagonal the exponent is
≥ 0 and overflows over a long chunk.

Dtypes as the reference's: the chunk bodies in f32 on the model dtype's
projections; Mamba2's causal conv multiplies the rows by f32 taps, so its
outputs (x, B, C) are f32 while its carried conv state keeps the rows'
dtype; ``softplus`` is ``logaddexp(x, 0)`` (no threshold), the logistic
is ``1 / (1 + exp(−x))``.

State conventions (per layer):
  mLSTM:  C [B, H, hd, hd], n [B, H, hd]
  sLSTM:  c [B, H, hd], n [B, H, hd], h [B, H, hd]
  mamba2: ssm [B, Hm, dh, ds], conv [B, W-1, d_conv_in]
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import _silu, dense_init, dtype_of, rms_norm

MAMBA_HEAD_DIM = 64


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands the logistic."""
    return 1 / (1 + torch.exp(-x))


def _causal_decay(cum: torch.Tensor) -> torch.Tensor:
    """cum [..., c] (a running sum of log decays) → [..., t, s]:
    ``exp(cum_t − cum_s)`` for s ≤ t, 0 above the diagonal."""
    c = cum.shape[-1]
    a = cum[..., :, None] - cum[..., None, :]
    above = torch.ones((c, c), dtype=torch.bool, device=cum.device).triu(1)
    return torch.exp(a.masked_fill(above, -math.inf))


def _chunks(S: int, chunk: int):
    """(chunk length c, padded length Sp) of an S-step sequence."""
    c = min(chunk, S)
    return c, -(-S // c) * c


def _pad_steps(a: torch.Tensor, Sp: int, value: float = 0.0) -> torch.Tensor:
    """a [B, S, …] padded along the steps to Sp with ``value``."""
    pad = Sp - a.shape[1]
    if not pad:
        return a
    return torch.cat([a, a.new_full((a.shape[0], pad, *a.shape[2:]), value)], dim=1)


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM) — linear-attention chunkwise form
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """The reference's mLSTM params, drawn in its key order on ``gen``'s
    device: ``w_up`` [d, 2·di] (x, gate), ``wq``/``wk``/``wv`` [di, di],
    ``w_if`` [di, 2H] f32 (input/forget gates), ``w_down`` [di, d]."""
    d, H = cfg.d_model, cfg.num_heads
    di = cfg.ssm_expand * d if cfg.ssm_expand else 2 * d
    dt = dtype_of(cfg)
    return {
        "w_up": dense_init(gen, (d, 2 * di), 0, dt),
        "wq": dense_init(gen, (di, di), 0, dt),
        "wk": dense_init(gen, (di, di), 0, dt),
        "wv": dense_init(gen, (di, di), 0, dt),
        "w_if": dense_init(gen, (di, 2 * H), 0, torch.float32),
        "w_down": dense_init(gen, (di, d), 0, dt),
        "norm": torch.zeros((di,), dtype=torch.float32, device=gen.device),
    }


def _mlstm_chunk(q, k, v, ig, fg, C, n):
    """One chunk of the mLSTM recurrence in parallel form, head-major.

    q/k/v [B, H, c, hd] (the model's dtype); ig/fg [B, H, c] f32 (input
    gate ≥ 0, forget ∈ (0, 1)); state C [B, H, hd, hd], n [B, H, hd] f32.
    Returns (h [B, H, c, hd] in q's dtype, C', n')."""
    logf = torch.log(fg + 1e-9)
    cum = torch.cumsum(logf, dim=-1)                          # Π f up to t (inclusive)
    tot = cum[..., -1:]                                       # [B, H, 1]
    dec_in = torch.exp(cum)[..., None]                        # state entry → t
    w = _causal_decay(cum) * ig[..., None, :]                 # [B, H, t, s]
    qf, kf, vf = q.float(), k.float(), v.float()
    num = (qf @ kf.transpose(-1, -2) * w) @ vf + (qf @ C) * dec_in
    n_all = w @ kf + n[..., None, :] * dec_in                 # n_intra + n_inter
    den = (qf * n_all).sum(-1)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    # C' = (Π f) C + Σ_s (Π_{r>s} f_r) i_s k_s v_sᵀ
    decay_out = torch.exp(tot)                                # [B, H, 1]
    wk = (torch.exp(tot - cum) * ig)[..., None] * kf          # [B, H, c, hd]
    C_new = C * decay_out[..., None] + wk.transpose(-1, -2) @ vf
    n_new = n * decay_out + wk.sum(-2)
    return h.to(q.dtype), C_new, n_new


def mlstm_mix(p, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 128,
              unroll_chunks: bool = False,
              state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x [B, S, D] → (y [B, S, D], state' = (C, n)), from ``state`` (zeros
    when None). Padded steps have ig = 0 and fg = 1: no-ops on the state.
    ``unroll_chunks`` is accepted for the reference's signature (the chunk
    loop is a Python loop either way)."""
    B, S, D = x.shape
    H = cfg.num_heads
    up = x @ p["w_up"]
    di = up.shape[-1] // 2
    inner, gate = up[..., :di], up[..., di:]
    hd = di // H

    def heads(a):                                             # [B, S, di] → [B, H, S, hd]
        return a.reshape(B, S, H, hd).transpose(1, 2)

    q = heads(inner @ p["wq"])
    k = heads((inner @ p["wk"]) / torch.sqrt(torch.tensor(hd, dtype=x.dtype)))
    v = heads(inner @ p["wv"])
    gif = inner.float() @ p["w_if"]
    ig = torch.exp(torch.clamp(gif[..., :H], max=8.0)).transpose(1, 2)     # [B, H, S]
    fg = _sigmoid(gif[..., H:]).transpose(1, 2)

    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    else:
        C, n = state
    c, Sp = _chunks(S, chunk)
    if Sp > S:                                                # padded steps: no-ops
        pad = lambda a, val=0.0: _pad_steps(a.transpose(1, 2), Sp, val).transpose(1, 2)
        q, k, v, ig, fg = pad(q), pad(k), pad(v), pad(ig), pad(fg, 1.0)
    hs = []
    for lo in range(0, Sp, c):
        h, C, n = _mlstm_chunk(q[:, :, lo:lo + c], k[:, :, lo:lo + c], v[:, :, lo:lo + c],
                               ig[..., lo:lo + c], fg[..., lo:lo + c], C, n)
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :S].transpose(1, 2).reshape(B, S, di)
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    return (h * _silu(gate)) @ p["w_down"], (C, n)


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with recurrent weights) — sequential
# ---------------------------------------------------------------------------


def init_slstm(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """``w_in`` [d, 4d] (z, i, f, o pre-activations), ``r`` [H, hd, 4hd] f32
    (fan-in axis 1), ``w_down`` [d, d]."""
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    dt = dtype_of(cfg)
    return {
        "w_in": dense_init(gen, (d, 4 * d), 0, dt),
        "r": dense_init(gen, (H, hd, 4 * hd), 1, torch.float32),
        "w_down": dense_init(gen, (d, d), 0, dt),
        "norm": torch.zeros((d,), dtype=torch.float32, device=gen.device),
    }


def slstm_mix(p, cfg: ModelConfig, x: torch.Tensor,
              state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
              **_) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """x [B, S, D] → (y, state' = (c, n, h)), one step at a time from
    ``state`` (c = 0, n = 1, h = 0 when None)."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    pre = (x @ p["w_in"]).reshape(B, S, H, 4 * hd).float().permute(1, 2, 0, 3)   # [S, H, B, 4hd]
    if state is None:
        c = torch.zeros((H, B, hd), dtype=torch.float32, device=x.device)
        n = torch.ones((H, B, hd), dtype=torch.float32, device=x.device)
        h = torch.zeros((H, B, hd), dtype=torch.float32, device=x.device)
    else:
        c, n, h = (a.transpose(0, 1) for a in state)
    hs = []
    for t in range(S):
        g = torch.baddbmm(pre[t], h, p["r"])                  # pre_t + h · r
        z, i, f, o = g.split(hd, dim=-1)
        i = torch.exp(torch.clamp(i, max=8.0))
        f = _sigmoid(f)
        c = f * c + i * torch.tanh(z)
        n = f * n + i
        h = _sigmoid(o) * c / torch.clamp(n.abs(), min=1.0)
        hs.append(h)
    y = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, D).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_down"], tuple(a.transpose(0, 1) for a in (c, n, h))


# ---------------------------------------------------------------------------
# Mamba2 (SSD) — chunkwise linear-attention form
# ---------------------------------------------------------------------------


def init_mamba2(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """``w_in`` [d, 2·di + 2·ds + Hm] (z, xBC, dt), ``conv`` [W, di + 2·ds]
    f32 at half ``dense_init``'s spread, ``A_log`` = log(1 … Hm), ``D`` = 1,
    ``w_down`` [di, d]; Hm = di / 64 heads."""
    d, ds = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    Hm = di // MAMBA_HEAD_DIM
    dt_ = dtype_of(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_in = dense_init(gen, (d, 2 * di + 2 * ds + Hm), 0, dt_)
    conv = dense_init(gen, (cfg.ssm_conv, di + 2 * ds), 0, torch.float32) * 0.5
    return {
        "w_in": w_in,
        "conv": conv,
        "A_log": torch.log(torch.arange(1, Hm + 1, **f32)),
        "D": torch.ones((Hm,), **f32),
        "dt_bias": torch.zeros((Hm,), **f32),
        "norm": torch.zeros((di,), **f32),
        "w_down": dense_init(gen, (di, d), 0, dt_),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv. xbc [B, S, C], w [W, C] f32. Returns (silu of
    the f32 sums [B, S, C], the new state [B, W-1, C] in xbc's dtype)."""
    B, S, C = xbc.shape
    W = w.shape[0]
    if conv_state is None:
        conv_state = xbc.new_zeros((B, W - 1, C))
    ext = torch.cat([conv_state, xbc], dim=1)                 # [B, S+W-1, C]
    y = ext[:, 0:S].float() * w[0]
    for i in range(1, W):
        y = y + ext[:, i:i + S].float() * w[i]
    return _silu(y), ext[:, S:]


def _ssd_chunk(xh, dt, A, Bm, Cm, ssm):
    """One SSD chunk, head-major. xh [B, Hm, c, dh]; dt [B, Hm, c]; A [Hm]
    (< 0); Bm/Cm [B, c, ds]; ssm [B, Hm, dh, ds]; all f32. Returns
    (y [B, Hm, c, dh], ssm')."""
    cum = torch.cumsum(dt * A[:, None], dim=-1)               # [B, Hm, c] ≤ 0
    tot = cum[..., -1:]
    cb = (Cm @ Bm.transpose(-1, -2))[:, None] * _causal_decay(cum)     # [B, Hm, t, s]
    y = (cb * dt[..., None, :]) @ xh + (Cm[:, None] @ ssm.transpose(-1, -2)) * (
        torch.exp(cum)[..., None])
    wk = (torch.exp(tot - cum) * dt)[..., None] * xh          # [B, Hm, c, dh]
    ssm_new = ssm * torch.exp(tot)[..., None] + wk.transpose(-1, -2) @ Bm[:, None]
    return y, ssm_new


def mamba2_mix(p, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 128,
               unroll_chunks: bool = False,
               state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x [B, S, D] → (y, (ssm_state, conv_state)); padded steps have dt = 0.
    ``unroll_chunks`` as in :func:`mlstm_mix`."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    ds = cfg.ssm_state
    dh = MAMBA_HEAD_DIM
    Hm = di // dh
    proj = x @ p["w_in"]
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * ds]
    dt_pre = proj[..., 2 * di + 2 * ds:].float()              # [B, S, Hm]
    ssm, conv0 = (None, None) if state is None else state
    xbc_c, conv_new = _causal_conv(xbc, p["conv"], conv0)
    xh = xbc_c[..., :di].reshape(B, S, Hm, dh)
    Bm = xbc_c[..., di:di + ds]
    Cm = xbc_c[..., di + ds:]
    v = dt_pre + p["dt_bias"]
    dt = torch.logaddexp(v, v.new_zeros(()))                  # softplus, no threshold
    A = -torch.exp(p["A_log"])
    if ssm is None:
        ssm = torch.zeros((B, Hm, dh, ds), dtype=torch.float32, device=x.device)

    c, Sp = _chunks(S, chunk)
    xh_h = _pad_steps(xh, Sp).transpose(1, 2)                 # [B, Hm, Sp, dh]
    dt_h = _pad_steps(dt, Sp).transpose(1, 2)                 # [B, Hm, Sp]; 0: no-op steps
    Bm_p, Cm_p = _pad_steps(Bm, Sp), _pad_steps(Cm, Sp)
    ys = []
    for lo in range(0, Sp, c):
        y, ssm = _ssd_chunk(xh_h[:, :, lo:lo + c], dt_h[..., lo:lo + c], A,
                            Bm_p[:, lo:lo + c], Cm_p[:, lo:lo + c], ssm)
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :S].transpose(1, 2)        # [B, S, Hm, dh]
    y = y + xh * p["D"][:, None]                              # skip
    y = rms_norm(y.reshape(B, S, di).to(x.dtype), p["norm"], cfg.norm_eps)
    return (y * _silu(z)) @ p["w_down"], (ssm, conv_new)
