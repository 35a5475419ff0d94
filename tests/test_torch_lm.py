"""The port's LM substrate (configs, layers, forward / prefill, init) against
``repro.models`` on the CPU.

The same seeded numpy inputs and the reference's own parameters, carried
across with ``params_from_reference``, go through both packages; the
reference runs under ``jax.jit`` with the config static (``RefJit``).
``forward`` / ``prefill`` at rtol = atol = 1e-4 in fp32 (the CPU tests'
fp32 rule) and at ``BF16_TOL`` in the configs' own bf16 (measured: see
the constant). The layers are in ``test_torch_lm_layers.py``, the decode
path in ``test_torch_lm_decode.py``.
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
from repro.config import applicable_shapes as r_applicable_shapes
from repro.models import RunCtx as RRunCtx
from repro.models import forward as r_forward
from repro.models import init_params as r_init_params
from repro.models import lm as rlm
from repro_torch import configs as tcfgs
from repro_torch.config import SHAPES, applicable_shapes, shape_by_name
from repro_torch.models import (
    RunCtx,
    VirtualMesh,
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_reference,
    prefill,
    unit_layout,
)
from repro_torch.models import lm as tlm

ROOT = Path(__file__).resolve().parents[1]
ARCHS = rcfgs.arch_names()
# the transformer-unit families without experts: this slice of the port
SERVED = ["gemma3-27b", "hubert-xlarge", "internlm2-20b", "phi3-mini-3.8b",
          "qwen1.5-4b", "qwen2-vl-7b"]
# the MoE family: through RunCtx() (the dense path) and VirtualMesh(data=2)
MOE = ["kimi-k2-1t-a32b", "olmoe-1b-7b"]
EP_CTX = 2                    # the data axis of the VirtualMesh cases
TOL32 = dict(rtol=1e-4, atol=1e-4)
# bf16 logits. The reference is compiled with XLA's excess precision off
# (``RefJit``), so that each jnp op rounds to bf16 as its semantics say and
# the port computes: by default XLA's CPU fusions skip some of those
# roundings (a residual sum feeds the next norm unrounded), which moved
# 43 % of one smoke block's outputs. What is left is the f32 summation
# order of the bf16 matrix products (XLA's dot against oneDNN's), a last
# bf16 bit of a logit at most: the largest |Δ| over the six smoke configs
# was 0.0175 at |logit| ≤ 3.8 (Qwen1.5's), Gemma3's bit for bit. The rule
# is the reference's own decode-vs-forward bound.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
CTX = RunCtx(q_chunk=16)
RCTX = RRunCtx(q_chunk=16)


def fp32(cfg):
    return cfg.replace(dtype="float32", param_dtype="float32")


def np32(x):
    """A tensor or array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def ref_params_np(arch, seed=0):
    """The reference's smoke params for ``arch`` as a numpy tree (bf16
    leaves as ml_dtypes arrays)."""
    cfg = rcfgs.get_smoke_config(arch)
    return jax.device_get(r_init_params(cfg, jax.random.PRNGKey(seed)))


def ref_tree(arch, dtype):
    """The reference's params in ``dtype`` (f32 = the bf16 init widened)."""
    tree = ref_params_np(arch)
    if dtype == "float32":
        return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return tree


class RefJit:
    """``jax.jit(fn)`` compiled per input signature with XLA's excess
    precision off: every op of the reference rounds to its dtype."""

    def __init__(self, fn):
        self.jitted, self.compiled = jax.jit(fn), {}

    def __call__(self, *args):
        key = (jax.tree.structure(args),
               tuple((np.shape(a), str(np.asarray(a).dtype)) for a in jax.tree.leaves(args)))
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self.compiled[key](*args)


@functools.lru_cache(maxsize=None)
def ref_forward(cfg, ctx):
    return RefJit(lambda p, b: r_forward(p, cfg, b, ctx))


def np_batch(cfg, B=2, S=32, seed=0):
    """``tests/models/test_archs_smoke.py``'s inputs: tokens (Qwen2-VL with
    patch positions on a prefix) or HuBERT's frames, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
        pos[1, :, : S // 4] += 3
        pos[2, :, : S // 4] += 5
        batch["positions"] = pos.astype(np.int32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        r, t = getattr(rcfgs, get)(arch), getattr(tcfgs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), (arch, get)
        assert t.is_moe == r.is_moe
        assert [s.name for s in applicable_shapes(t)] == [
            s.name for s in r_applicable_shapes(r)]
        assert unit_layout(t) == rlm.unit_layout(r)


def test_registry_and_shapes():
    assert tcfgs.arch_names() == ARCHS
    from repro.config import SHAPES as RSHAPES
    assert [dataclasses.asdict(s) for s in SHAPES] == [dataclasses.asdict(s) for s in RSHAPES]
    assert shape_by_name("decode_32k").kind == "decode"
    with pytest.raises(KeyError):
        shape_by_name("train_1m")
    with pytest.raises(KeyError):
        tcfgs.get_config("gpt-2")
    lo = unit_layout(tcfgs.get_config("gemma3-27b"))
    assert lo["n_units"] * lo["unit_layers"] + lo["tail_locals"] == 62
    assert (lo["n_units"], lo["locals"], lo["tail_locals"]) == (10, 5, 2)


# ---------------------------------------------------------------- forward / prefill
def ep_ctx(drops, **kw):
    """``RunCtx`` over ``VirtualMesh(data=EP_CTX)`` logging dropped slots."""
    return RunCtx(mesh=VirtualMesh(EP_CTX, drop_log=drops), **kw)


def check_forward_and_prefill(arch, dtype):
    """The port's forward and prefill against the reference's forward; an
    MoE config also through ``VirtualMesh(data=2)``, where no slot drops at
    the default capacity, against the same (dense) reference. The EP aux
    is the mean of the ranks' own (``test_torch_moe.py`` holds it against
    the reference's EP layer), not the dense path's."""
    cfg = rcfgs.get_smoke_config(arch)
    if dtype == "float32":
        cfg = fp32(cfg)
    tol = TOL32 if dtype == "float32" else BF16_TOL
    tree = ref_tree(arch, dtype)
    batch = np_batch(cfg)
    want, want_aux = ref_forward(cfg, RCTX)(tree, to_jax(batch))
    want = np.asarray(want)
    params = params_from_reference(cfg, tree, device="cpu")
    drops = []
    ctxs = [CTX] + ([ep_ctx(drops, q_chunk=16)] if cfg.is_moe else [])
    for ctx in ctxs:
        got, aux = forward(params, cfg, to_torch(batch), ctx)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert aux.dtype == torch.float32 and aux.shape == ()
        if ctx.mesh is None:
            np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-6)
        else:
            assert np.isfinite(float(aux)) and float(aux) > 0
        np.testing.assert_allclose(got.numpy(), want, **tol)
        # the reference's prefill is its forward's last position
        last = prefill(params, cfg, to_torch(batch), ctx)
        assert torch.equal(last, got[:, -1])
        np.testing.assert_allclose(last.numpy(), want[:, -1], **tol)
    assert (float(want_aux) > 0) == cfg.is_moe
    assert len(drops) == 2 * cfg.num_layers * cfg.is_moe and all(int(d.sum()) == 0 for d in drops)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [a for a in SERVED if a != "gemma3-27b"] + MOE)
def test_forward_and_prefill_match_reference(arch, dtype):
    check_forward_and_prefill(arch, dtype)


# ---------------------------------------------------------------- init / carry-over
@pytest.mark.parametrize("arch", SERVED + MOE)
def test_init_params_has_the_reference_tree(arch):
    cfg = rcfgs.get_smoke_config(arch)
    want = jax.eval_shape(lambda k: r_init_params(cfg, k), jax.random.PRNGKey(0))
    got = init_params(cfg, 0, device="cpu")
    flat_w = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    for key, leaf in flat_w.items():
        assert tuple(flat_g[key].shape) == tuple(leaf.shape), key
        assert str(flat_g[key].dtype).replace("torch.", "") == str(leaf.dtype), key


def test_init_params_is_seeded_and_spread_as_the_reference():
    cfg = rcfgs.get_smoke_config("qwen1.5-4b")
    a = init_params(cfg, 3, device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, 4, device="cpu")
    assert torch.equal(a["units"]["block"]["attn"]["wq"], b["units"]["block"]["attn"]["wq"])
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    std = 0.8796                  # a unit normal truncated to [-2, 2]
    for leaf, fan_in in ((a["embed"], 1), (a["lm_head"], cfg.d_model),
                         (a["units"]["block"]["attn"]["wq"], cfg.d_model),
                         (a["units"]["block"]["ffn"]["w2"], cfg.d_ff)):
        x = leaf.float()
        want = std / np.sqrt(fan_in)
        assert abs(float(x.std()) / want - 1) < 0.05, (tuple(leaf.shape), float(x.std()), want)
        assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) * 1.01
        assert abs(float(x.mean())) < 0.05 * want
    assert not torch.equal(a["units"]["block"]["attn"]["wq"][0],
                           a["units"]["block"]["attn"]["wq"][1])     # units drawn apart
    assert float(a["units"]["block"]["attn"]["bq"].abs().max()) == 0.0
    assert float(a["final_norm"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_is_seeded_and_spread_as_the_reference(arch):
    """The MoE subtree drawn after the attention, as the reference's
    ``init_moe``: an f32 router (fan-in d), experts in the config's dtype
    with fan-in on axis 1 (d for w1 / w3, d_ff for w2)."""
    cfg = rcfgs.get_smoke_config(arch)
    a = init_params(cfg, 3, device="cpu")
    b = init_params(cfg, 3, device="cpu")
    c = init_params(cfg, 4, device="cpu")
    moe = a["units"]["block"]["moe"]
    assert "ffn" not in a["units"]["block"]
    assert torch.equal(moe["w1"], b["units"]["block"]["moe"]["w1"])
    assert not torch.equal(moe["w1"], c["units"]["block"]["moe"]["w1"])
    assert moe["router"].dtype == torch.float32 and moe["w2"].dtype == torch.bfloat16
    std = 0.8796                  # a unit normal truncated to [-2, 2]
    for leaf, fan_in in ((moe["router"], cfg.d_model), (moe["w1"], cfg.d_model),
                         (moe["w3"], cfg.d_model), (moe["w2"], cfg.d_ff)):
        x = leaf.float()
        want = std / np.sqrt(fan_in)
        assert abs(float(x.std()) / want - 1) < 0.05, (tuple(leaf.shape), float(x.std()), want)
        assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) * 1.01
        assert abs(float(x.mean())) < 4 * want / np.sqrt(x.numel())     # 4 σ of the mean
    assert not torch.equal(moe["w1"][0, 0], moe["w1"][0, 1])          # experts drawn apart
    assert not torch.equal(moe["w1"][0], moe["w1"][1])                # units drawn apart


# ---------------------------------------------------------------- boundaries
def test_entry_points_need_cuda_by_default(monkeypatch):
    cfg = tcfgs.get_smoke_config("qwen1.5-4b")
    tree = ref_tree("qwen1.5-4b", "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(cfg, tree)
    assert init_params(cfg, 0, device="cpu")["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tcfgs.get_smoke_config("olmoe-1b-7b"), 0)


def test_runctx_mesh_and_head_sharding_raise():
    with pytest.raises(NotImplementedError, match="one card"):
        RunCtx(mesh=object())
    with pytest.raises(NotImplementedError, match="one card"):
        RunCtx(shard_heads=True)
    assert RunCtx(q_chunk=8, rec_chunk=4, unroll_chunks=True, kv_range_chunking=True,
                  n_units_override=1).q_chunk == 8


def test_runctx_takes_a_virtual_mesh():
    assert RunCtx(mesh=VirtualMesh(4)).mesh.shape == {"data": 4, "model": 1}
    with pytest.raises(NotImplementedError, match="one card"):
        RunCtx(mesh=VirtualMesh(2), shard_heads=True)
    cfg = fp32(tcfgs.get_smoke_config("olmoe-1b-7b"))
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="batch 3"):
        forward(params, cfg, {"tokens": torch.zeros((3, 4), dtype=torch.long)},
                RunCtx(mesh=VirtualMesh(2)))


def test_models_and_configs_import_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.models.common\n"
        "cfg = repro_torch.configs.get_smoke_config('qwen1.5-4b')\n"
        "p = repro_torch.models.init_params(cfg, 0, device='cpu')\n"
        "import torch\n"
        "lg = repro_torch.models.prefill(p, cfg, {'tokens': torch.zeros(1, 4, dtype=torch.long)})\n"
        "print('OK', tuple(lg.shape))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK (1, 512)" in proc.stdout


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_full_width_forward_matches_cpu():
    """Qwen1.5-4B at its published width, 2 layers, fp32: the card's logits
    against the CPU's on the same params (TF32 off) at 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = fp32(tcfgs.get_config("qwen1.5-4b")).replace(num_layers=2)
    params = init_params(cfg, 0, device="cuda")
    cpu = tlm.map_tree(params, lambda t: t.cpu())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64)))
    got, _ = forward(params, cfg, {"tokens": toks.cuda()})
    want, _ = forward(cpu, cfg, {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_cuda_olmoe_full_width_forward_matches_cpu():
    """OLMoE-1B-7B at its published width (64 experts, top-8), 2 layers,
    fp32: the card's logits and aux against the CPU's on the same params
    (TF32 off) at 1e-3, through the dense path and ``VirtualMesh(2)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = fp32(tcfgs.get_config("olmoe-1b-7b")).replace(num_layers=2)
    params = init_params(cfg, 0, device="cuda")
    cpu = tlm.map_tree(params, lambda t: t.cpu())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64)))
    for ctx in (RunCtx(), RunCtx(mesh=VirtualMesh(2))):
        got, aux = forward(params, cfg, {"tokens": toks.cuda()}, ctx)
        want, want_aux = forward(cpu, cfg, {"tokens": toks}, ctx)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)
