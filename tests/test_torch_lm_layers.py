"""The port's LM layers (``repro_torch.models.common`` and the ring-buffer
decode of ``lm``) against ``repro.models`` on the CPU, in fp32 at
rtol = atol = 1e-5: the same seeded numpy inputs and the reference's own
layer params (attention biases made non-zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import common as rcm
from repro.models import lm as rlm
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from test_torch_lm import fp32, np32

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm():
    x, w = _x((2, 5, 64)), _x((64,), 1, 0.1)
    want = rcm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tcm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(np32(got), np32(want), **LAYER_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = _x((2, 7, 4, 16))
    pos = np.random.default_rng(2).integers(0, 64, size=(2, 7)).astype(np.int32)
    want = rcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(np32(got), np32(want), **LAYER_TOL)


def test_apply_mrope():
    x = _x((2, 6, 2, 128))
    pos3 = np.random.default_rng(3).integers(0, 40, size=(3, 2, 6)).astype(np.int32)
    want = rcm.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = tcm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6)
    np.testing.assert_allclose(np32(got), np32(want), **LAYER_TOL)
    # text tokens (equal sections) reduce to plain RoPE
    flat = np.broadcast_to(pos3[:1], pos3.shape).copy()
    np.testing.assert_allclose(
        np32(tcm.apply_mrope(torch.from_numpy(x), torch.from_numpy(flat), 1e6)),
        np32(tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(flat[0]), 1e6)),
        **LAYER_TOL)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        tcm.apply_mrope(torch.from_numpy(x[..., :64]), torch.from_numpy(pos3), 1e6)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma3-27b"])     # SwiGLU, tanh-GELU
def test_ffn(arch):
    cfg = fp32(rcfgs.get_smoke_config(arch))
    p = jax.device_get(rcm.init_ffn(cfg, jax.random.PRNGKey(4)))
    x = _x((2, 5, cfg.d_model))
    want = rcm.ffn(p, cfg, jnp.asarray(x))
    got = tcm.ffn({k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, cfg,
                  torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), **LAYER_TOL)


def _attn_params(cfg, seed=5):
    """Reference attention params with non-zero biases (init has zeros)."""
    p = jax.device_get(rcm.init_attention(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):
        if b in p:
            p[b] = (rng.standard_normal(p[b].shape) * 0.1).astype(np.float32)
    return p, {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


# GQA (8 heads over 2 KV heads) with QKV bias; one case with a softcap
ATTN_CFG = fp32(rcfgs.get_smoke_config("internlm2-20b")).replace(qkv_bias=True)
ATTN_CASES = {
    "causal": dict(S=12, kw=dict(causal=True)),
    "sliding": dict(S=12, kw=dict(causal=True, sliding_window=4)),
    "bidirectional": dict(S=12, kw=dict(causal=False)),
    "chunked": dict(S=21, kw=dict(causal=True, q_chunk=8)),
    "chunked_sliding": dict(S=21, kw=dict(causal=True, sliding_window=5, q_chunk=8)),
    "kv_range_unrolled": dict(S=21, kw=dict(causal=True, q_chunk=8, unroll_chunks=True,
                                            kv_range_chunking=True)),
    "kv_range_unrolled_sliding": dict(S=21, kw=dict(causal=True, sliding_window=5, q_chunk=8,
                                                    unroll_chunks=True,
                                                    kv_range_chunking=True)),
    "kv_range_scan_ignored": dict(S=21, kw=dict(causal=False, q_chunk=8,
                                                kv_range_chunking=True)),
    "softcap": dict(S=12, kw=dict(causal=True), cfg=dict(attn_logit_softcap=0.5)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention(case):
    spec = ATTN_CASES[case]
    cfg = ATTN_CFG.replace(**spec.get("cfg", {}))
    rp, tp = _attn_params(cfg)
    x = _x((2, spec["S"], cfg.d_model))
    pos = np.broadcast_to(np.arange(spec["S"], dtype=np.int32), (2, spec["S"])).copy()
    want = rcm.attention(rp, cfg, jnp.asarray(x), jnp.asarray(pos), **spec["kw"])
    got = tcm.attention(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), **spec["kw"])
    np.testing.assert_allclose(np32(got), np32(want), **LAYER_TOL)


def test_attention_mrope_and_no_rope():
    for cfg, pos in (
            (fp32(rcfgs.get_smoke_config("qwen2-vl-7b")),
             np.random.default_rng(6).integers(0, 30, size=(3, 2, 10)).astype(np.int32)),
            (ATTN_CFG.replace(rope_style="none"),
             np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy())):
        rp, tp = _attn_params(cfg)
        x = _x((2, 10, cfg.d_model))
        want = rcm.attention(rp, cfg, jnp.asarray(x), jnp.asarray(pos), q_chunk=4)
        got = tcm.attention(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), q_chunk=4)
        np.testing.assert_allclose(np32(got), np32(want), **LAYER_TOL)


def _cache(shape, seed):
    return _x(shape, seed, 0.5)


@pytest.mark.parametrize("sliding", [0, 3])
def test_attention_decode(sliding):
    cfg = ATTN_CFG
    rp, tp = _attn_params(cfg)
    B, Smax = 2, 9
    x = _x((B, 1, cfg.d_model), 7)
    k = _cache((B, Smax, cfg.num_kv_heads, cfg.head_dim), 8)
    v = _cache((B, Smax, cfg.num_kv_heads, cfg.head_dim), 9)
    pos = np.array([4, 8], np.int32)
    want = rcm.attention_decode(rp, cfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(k),
                                jnp.asarray(v), sliding_window=sliding)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = tcm.attention_decode(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), tk, tv,
                               sliding_window=sliding)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), **LAYER_TOL)
    assert got[1] is tk and got[2] is tv            # written in place


def test_attention_decode_mrope():
    cfg = fp32(rcfgs.get_smoke_config("qwen2-vl-7b"))
    rp, tp = _attn_params(cfg)
    B, Smax = 2, 6
    x = _x((B, 1, cfg.d_model), 7)
    k = _cache((B, Smax, cfg.num_kv_heads, cfg.head_dim), 8)
    v = _cache((B, Smax, cfg.num_kv_heads, cfg.head_dim), 9)
    for pos in (np.array([2, 5], np.int32), np.array([[2, 5], [3, 1], [4, 0]], np.int32)):
        want = rcm.attention_decode(rp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                    jnp.asarray(k), jnp.asarray(v))
        got = tcm.attention_decode(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                   torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), np32(w), **LAYER_TOL)


def test_ring_attention_decode():
    """Slot ``pos % W``, empty slots at −1, the window against the stored
    positions: before and after the ring wraps."""
    cfg = ATTN_CFG.replace(sliding_window=4)
    rp, tp = _attn_params(cfg)
    B, W = 2, 4
    k = _cache((B, W, cfg.num_kv_heads, cfg.head_dim), 10)
    v = _cache((B, W, cfg.num_kv_heads, cfg.head_dim), 11)
    for step, (pos, pc) in enumerate((
            (np.array([2, 1], np.int32), np.array([[0, 1, -1, -1], [0, -1, -1, -1]], np.int32)),
            (np.array([6, 9], np.int32), np.array([[4, 5, 2, 3], [8, 5, 6, 7]], np.int32)))):
        x = _x((B, 1, cfg.d_model), 12 + step)
        want = rlm._ring_attention_decode(rp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                          jnp.asarray(k), jnp.asarray(v), jnp.asarray(pc))
        got = tlm._ring_attention_decode(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                         torch.from_numpy(k.copy()),
                                         torch.from_numpy(v.copy()),
                                         torch.from_numpy(pc.copy()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), np32(w), **LAYER_TOL)
        assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
