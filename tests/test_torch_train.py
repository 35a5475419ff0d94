"""The port's ``loss_fn`` and its gradients (``torch.autograd``) against
``repro.models.loss_fn`` under ``jax.grad`` on the CPU.

Every smoke architecture in fp32, on the batches of
``tests/models/test_archs_smoke.py`` (tokens, Qwen2-VL's patch
positions, HuBERT's frames with a ``loss_mask``, the MoE aux), with the
reference's own params carried across: the loss and its metrics at
rtol = atol = 1e-4, every gradient leaf at 1e-4 in units of that leaf's
max |g_ref| (the reference under ``jax.jit``; measured: under 5e-6). The
port recomputes each unit under ``torch.utils.checkpoint`` when
``cfg.remat`` (``RunCtx.remat_policy`` "full" or "dots"), and without
it when not; all three give the reference's gradients. The mirror of
``test_forward_backward_smoke`` runs the configs in their own bf16.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import RunCtx as RRunCtx
from repro.models import loss_fn as r_loss_fn
from repro_torch import configs as tcfgs
from repro_torch.models import RunCtx, VirtualMesh, forward, init_params, loss_fn
from repro_torch.models import params_from_reference
from repro_torch.models.lm import map_tree
from test_torch_lm import TOL32, fp32, ref_tree

ROOT = Path(__file__).resolve().parents[1]
ARCHS = rcfgs.arch_names()
GRAD_TOL = 1e-4               # a gradient leaf's max |Δ| over its max |g_ref|
CTX = dict(q_chunk=16, rec_chunk=8)
# Gemma3's smoke stack is 8 layers (a 5 + 1 unit and 2 tail locals) and
# Zamba2's 4 Mamba2 blocks with the shared block per unit, the costliest
# to trace: S = 40 keeps Gemma3 past its window of 32 and both quick.
SEQ = {"gemma3-27b": 40, "zamba2-2.7b": 24}


def smoke_batch(cfg, B=2, S=32, seed=0):
    """``tests/models/test_archs_smoke.py``'s ``_batch``, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        frames = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        targets = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        mask = (rng.random((B, S)) < 0.3).astype(np.float32)
        return {"frames": frames, "targets": targets, "loss_mask": mask}
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
        pos[1, :, : S // 4] += 3     # patch positions on a prefix
        pos[2, :, : S // 4] += 5
        batch["positions"] = pos.astype(np.int32)
    return batch


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


@functools.lru_cache(maxsize=None)
def reference_grads(arch):
    """(batch, loss, metrics, grads) of the reference's fp32 ``loss_fn``
    under ``jax.value_and_grad``, as numpy."""
    cfg = fp32(rcfgs.get_smoke_config(arch))
    batch = smoke_batch(cfg, S=SEQ.get(arch, 32))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: r_loss_fn(p, cfg, b, RRunCtx(**CTX)), has_aux=True))
    (loss, metrics), grads = fn(ref_tree(arch, "float32"),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), jax.device_get(metrics), jax.device_get(grads)


def port_loss_and_grads(arch, cfg, ctx, params=None):
    """The port's (loss, metrics, [(name, grad)]) on the reference's batch
    and params (fp32), by ``torch.autograd.grad`` over every leaf."""
    batch, *_ = reference_grads(arch)
    if params is None:
        params = params_from_reference(cfg, ref_tree(arch, "float32"), device="cpu")
    params = map_tree(params, lambda t: t.detach().requires_grad_())
    leaves = named_leaves(params)
    total, metrics = loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                             ctx)
    grads = torch.autograd.grad(total, [t for _, t in leaves], allow_unused=True)
    return total.detach(), metrics, [(n, g) for (n, _), g in zip(leaves, grads)]


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_grad(arch, remat):
    _, want_loss, want_metrics, want_grads = reference_grads(arch)
    cfg = fp32(tcfgs.get_smoke_config(arch)).replace(remat=remat != "off")
    ctx = RunCtx(**CTX, remat_policy="dots" if remat == "dots" else "full")
    total, metrics, grads = port_loss_and_grads(arch, cfg, ctx)
    np.testing.assert_allclose(float(total), want_loss, **TOL32)
    for k in ("loss", "aux", "logits_mean_abs"):
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), **TOL32)
    want = dict(named_leaves(want_grads))
    assert [n for n, _ in grads] == list(want)
    for name, g in grads:
        ref = np.asarray(want[name], np.float32)
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert got.shape == ref.shape, name
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got - ref).max()) / scale
        assert err <= GRAD_TOL, (arch, remat, name, err)


def test_loss_mask_and_denominator():
    """Masked loss = Σ nll · mask / max(Σ mask, 1): an all-zero mask gives
    0 (not NaN), a full mask the unmasked mean."""
    cfg = fp32(tcfgs.get_smoke_config("hubert-xlarge"))
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg).items()}
    mask = batch["loss_mask"]
    zero, _ = loss_fn(params, cfg, dict(batch, loss_mask=torch.zeros_like(mask)))
    assert float(zero) == 0.0
    full, _ = loss_fn(params, cfg, dict(batch, loss_mask=torch.ones_like(mask)))
    plain, _ = loss_fn(params, cfg, {k: v for k, v in batch.items() if k != "loss_mask"})
    np.testing.assert_allclose(float(full), float(plain), rtol=1e-6)


def test_moe_aux_carries_its_gradient_to_the_router():
    """The load-balance term reaches the router through ``forward``'s aux:
    the router's gradient moves with ``load_balance_loss``, and d aux /
    d router is not zero."""
    arch = "olmoe-1b-7b"
    cfg = fp32(tcfgs.get_smoke_config(arch))
    params = params_from_reference(cfg, ref_tree(arch, "float32"), device="cpu")
    batch, *_ = reference_grads(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    router = params["units"]["block"]["moe"]["router"].detach().requires_grad_()
    params["units"]["block"]["moe"]["router"] = router
    _, aux = forward(params, cfg, tb, RunCtx(**CTX))
    (g_aux,) = torch.autograd.grad(aux, [router])
    assert float(g_aux.abs().max()) > 0
    grads = {}
    for lb in (0.0, 0.5):
        c = cfg.replace(moe=dataclasses.replace(cfg.moe, load_balance_loss=lb))
        total, _ = loss_fn(params, c, tb, RunCtx(**CTX))
        (grads[lb],) = torch.autograd.grad(total, [router])
    np.testing.assert_allclose((grads[0.5] - grads[0.0]).numpy(), 0.5 * g_aux.numpy(),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_logs_each_forward_pass_once(policy):
    """Under remat the unit is recomputed in the backward pass; the EP
    layer's ``drop_log`` still gets one entry per MoE layer per forward
    pass, and the gradients equal those without remat."""
    cfg = fp32(tcfgs.get_smoke_config("olmoe-1b-7b"))
    batch, *_ = reference_grads("olmoe-1b-7b")
    grads = {}
    for remat in (False, True):
        drops = []
        ctx = RunCtx(**CTX, mesh=VirtualMesh(2, drop_log=drops), remat_policy=policy)
        _, _, grads[remat] = port_loss_and_grads("olmoe-1b-7b", cfg.replace(remat=remat), ctx)
        assert len(drops) == cfg.num_layers, (remat, len(drops))
    for (name, a), (_, b) in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def test_remat_only_where_autograd_records(monkeypatch):
    """No checkpoint when nothing requires grad (serving), nor under
    ``torch.no_grad``; one per unit when training."""
    import torch.utils.checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = fp32(tcfgs.get_smoke_config("qwen1.5-4b"))
    params = init_params(cfg, 0, device="cpu")
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    forward(params, cfg, toks)
    live = map_tree(params, lambda t: t.detach().requires_grad_())
    with torch.no_grad():
        forward(live, cfg, toks)
    assert calls == []
    forward(live, cfg, toks)
    assert len(calls) == cfg.num_layers
    with pytest.raises(ValueError, match="remat_policy"):
        RunCtx(remat_policy="selective")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_backward_smoke(arch):
    """``tests/models/test_archs_smoke.py::test_forward_backward_smoke``
    through the port: the smoke config in its own dtype from the port's
    seeded init, one forward + backward; the loss and every gradient
    finite, signal in the embedding (or HuBERT's head)."""
    cfg = tcfgs.get_smoke_config(arch)
    params = map_tree(init_params(cfg, 0, device="cpu"), lambda t: t.requires_grad_())
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg, S=SEQ.get(arch, 32)).items()}
    total, _ = loss_fn(params, cfg, batch, RunCtx(**CTX))
    assert np.isfinite(float(total.detach())), arch
    leaves = named_leaves(params)
    grads = torch.autograd.grad(total, [t for _, t in leaves], allow_unused=True)
    for (name, _), g in zip(leaves, grads):
        assert g is None or bool(torch.isfinite(g.float()).all()), (arch, name)
    probe = dict(zip([n for n, _ in leaves], grads))["/embed" if cfg.frontend == "none"
                                                     else "/lm_head"]
    assert float(probe.float().abs().sum()) > 0


def test_train_modules_import_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.train, repro_torch.train.compression, repro_torch.data\n"
        "import repro_torch.launch.train\n"
        "from repro_torch.models import loss_fn\n"
        "print('OK', sorted(repro_torch.train.__all__))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ("OK ['OptConfig', 'global_norm', 'init_opt_state', 'make_train_step', "
            "'opt_update', 'train_loop']") in proc.stdout
