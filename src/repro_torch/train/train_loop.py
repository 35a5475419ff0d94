"""Training step and loop: microbatch gradient accumulation, grad clip,
optimizer update, metrics.

The port of ``repro.train.train_loop``. Gradients come from
``torch.autograd`` through ``models.loss_fn``. ``make_train_step``'s step
is functional, as the reference's: it returns new params and state and
leaves the caller's as they were. ``train_loop`` owns its optimizer
state and steps in place (``make_inplace_train_step``): the params it is
given and the moments are overwritten each step, since old and new
copies of a 4B model's params and AdamW moments do not fit beside each
other on one 80 GB card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import RunCtx, loss_fn
from repro_torch.train.optimizer import (
    OptConfig,
    _leaves,
    _map,
    init_opt_state,
    opt_update,
    opt_update_,
)


def _first_device(params) -> torch.device:
    return _leaves(params)[0].device


def _batch_on(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on ``dev``."""
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _grads_of(params, cfg: ModelConfig, batch, ctx: RunCtx):
    """(total loss, metrics, grads in the params' layout and dtypes) of one
    batch; a leaf the loss does not reach (HuBERT's embedding) gets a zero
    gradient, as ``jax.grad`` gives it."""
    flat = _leaves(params)
    live = [t.detach().requires_grad_() for t in flat]
    it = iter(live)
    p = _map(params, lambda _: next(it))
    with torch.enable_grad():
        total, metrics = loss_fn(p, cfg, batch, ctx)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads))
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            _map(params, lambda _: next(it)))


def _value_and_grads(cfg: ModelConfig, ocfg: OptConfig, ctx: RunCtx, microbatches: int):
    """(params, batch) → (loss, metrics, grads): one batch, or the mean
    over ``microbatches`` equal splits of its leading axis, summed in f32
    for AdamW and in the param dtype for Adafactor; the split step's
    metrics are its mean total loss with ``aux`` and ``logits_mean_abs``
    at 0, as the reference's."""
    accum_f32 = ocfg.name == "adamw"

    def run(params, batch):
        if microbatches == 1:
            return _grads_of(params, cfg, batch, ctx)
        for v in batch.values():
            if v.shape[0] % microbatches:
                raise ValueError(f"batch {v.shape[0]} is no multiple of {microbatches} "
                                 "microbatches")
        dev = _first_device(params)
        gsum = _map(params, lambda p: torch.zeros(
            p.shape, dtype=torch.float32 if accum_f32 else p.dtype, device=p.device))
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        parts = {k: v.chunk(microbatches) for k, v in batch.items()}
        for i in range(microbatches):
            loss, _, grads = _grads_of(params, cfg, {k: v[i] for k, v in parts.items()}, ctx)
            _map(gsum, lambda a, g: a.add_(g.to(a.dtype)), grads)
            lsum = lsum + loss
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return (lsum / microbatches, {"loss": lsum / microbatches, "aux": zero,
                                      "logits_mean_abs": zero},
                _map(gsum, lambda g: g / microbatches))

    return run


def make_train_step(
    cfg: ModelConfig,
    ocfg: OptConfig,
    ctx: RunCtx = RunCtx(),
    microbatches: int = 1,
):
    """Returns train_step(params, opt_state, batch) → (params', opt',
    metrics), functional: the caller's params and state are unchanged.
    ``batch`` holds numpy arrays or tensors (moved to the params' device).

    Microbatch accumulation: the global batch is split along axis 0 and
    grads are accumulated (accum dtype = f32 for AdamW models, param
    dtype for Adafactor giants)."""
    value_and_grads = _value_and_grads(cfg, ocfg, ctx, microbatches)

    def train_step(params, opt_state, batch):
        _, metrics, grads = value_and_grads(params, _batch_on(batch, _first_device(params)))
        new_params, new_opt = opt_update(params, grads, opt_state, ocfg)
        return new_params, new_opt, dict(metrics, grad_norm=new_opt["gnorm"])

    return train_step


def make_inplace_train_step(cfg: ModelConfig, ocfg: OptConfig, ctx: RunCtx = RunCtx()):
    """Returns step(params, opt_state, batch) → metrics: ``make_train_step``'s
    step (one microbatch) with the update written into ``params`` and
    ``opt_state`` (``opt_update_``), the same numbers."""
    value_and_grads = _value_and_grads(cfg, ocfg, ctx, 1)

    def step(params, opt_state, batch):
        _, metrics, grads = value_and_grads(params, _batch_on(batch, _first_device(params)))
        opt_update_(params, grads, opt_state, ocfg)
        return dict(metrics, grad_norm=opt_state["gnorm"])

    return step


def train_loop(
    cfg: ModelConfig,
    params,
    pipeline,
    steps: int,
    ocfg: Optional[OptConfig] = None,
    ctx: RunCtx = RunCtx(),
    checkpointer=None,
    ckpt_every: int = 0,
    start_step: int = 0,
    log_every: int = 10,
):
    """Host-side loop: deterministic data pipeline + in-place step +
    optional checkpointing of ``{"params", "opt"}``. The params given are
    updated in place. Returns (params, opt_state, loss history)."""
    ocfg = ocfg or OptConfig(name=cfg.optimizer)
    opt_state = init_opt_state(params, ocfg)
    step_fn = make_inplace_train_step(cfg, ocfg, ctx)
    history = []
    for step in range(start_step, start_step + steps):
        metrics = step_fn(params, opt_state, pipeline.batch_for_step(step))
        loss = float(metrics["loss"])
        history.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  gnorm {float(metrics['grad_norm']):.3f}")
        if checkpointer is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            checkpointer.save(step + 1, {"params": params, "opt": opt_state})
    return params, opt_state, history
