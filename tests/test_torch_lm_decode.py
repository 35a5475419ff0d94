"""The port's KV-cache decode (``init_cache``, ``decode_step``) against
``repro.models`` on the CPU.

A few decode steps of the reference fill a cache, which is carried across
(``cache_from_reference``); twelve more steps then run in both packages on
the same tokens and positions (a row one position ahead of the other),
and every step's logits and the final caches must agree: rtol = atol =
1e-4 in fp32, ``BF16_TOL`` in bf16 (the forward's measured rule; see
``test_torch_lm.py``). The port's teacher-forced decode must also give its
own ``forward`` at every position (fp32, 1e-4). Gemma3's local:global
pattern (ring buffers, tail locals) is in ``test_torch_lm_local_global.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import decode_step as r_decode_step
from repro.models import init_cache as r_init_cache
from repro_torch.models import lm as tlm
from repro_torch.models import (
    RunCtx,
    cache_from_reference,
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_reference,
)
from test_torch_lm import BF16_TOL, MOE, SERVED, TOL32, RefJit, ep_ctx, fp32, np32, ref_tree

# InternLM2's smoke config is the GQA case (8 query heads over 2 KV heads);
# Qwen2-VL's decodes with M-RoPE positions broadcast to [3, B]; the MoE
# configs decode through RunCtx() and VirtualMesh(data=2) (Kimi K2's GQA)
DECODE = ["internlm2-20b", "phi3-mini-3.8b", "qwen1.5-4b", "qwen2-vl-7b"] + MOE
B, MAX_LEN, PRIME, STEPS = 2, 20, 3, 12


def decode_cfg(arch, dtype):
    cfg = rcfgs.get_smoke_config(arch)
    if arch == "gemma3-27b":
        cfg = cfg.replace(sliding_window=8)        # the ring wraps within the run
    return fp32(cfg) if dtype == "float32" else cfg


@functools.lru_cache(maxsize=None)
def ref_decode(cfg):
    return RefJit(lambda p, tok, pos, cache: r_decode_step(p, cfg, tok, pos, cache))


def assert_trees_close(got, want, tol, what):
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys(), what
    for key, leaf in flat_w.items():
        g = flat_g[key]
        assert str(g.dtype).replace("torch.", "") == str(np.asarray(leaf).dtype), (what, key)
        if g.dtype == torch.int32:
            assert np.array_equal(g.numpy(), np.asarray(leaf)), (what, key)
        else:
            np.testing.assert_allclose(np32(g), np32(leaf), err_msg=f"{what} {key}", **tol)


def check_cache_tree(arch):
    """``init_cache``: the reference's keys, shapes and dtypes; zeros, and
    −1 for a ring's empty positions."""
    cfg = rcfgs.get_smoke_config(arch)
    want = jax.eval_shape(lambda: r_init_cache(cfg, B, MAX_LEN))
    got = init_cache(cfg, B, MAX_LEN, device="cpu")
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for key, leaf in flat_w.items():
        g = flat_g[key]
        assert tuple(g.shape) == tuple(leaf.shape), key
        assert str(g.dtype).replace("torch.", "") == str(leaf.dtype), key
        fill = -1 if jax.tree_util.keystr(key).endswith("['pos']") else 0
        assert bool((g == fill).all()), key


def check_decode_matches_reference(arch, dtype):
    cfg = decode_cfg(arch, dtype)
    tol = TOL32 if dtype == "float32" else BF16_TOL
    tree = ref_tree(arch, dtype)
    step = ref_decode(cfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(B, PRIME + STEPS)).astype(np.int32)
    offset = np.arange(B, dtype=np.int32)               # row b is b positions ahead
    cache = r_init_cache(cfg, B, MAX_LEN)
    for t in range(PRIME):
        _, cache = step(tree, toks[:, t], t + offset, cache)
    params = params_from_reference(cfg, tree, device="cpu")
    drops = []
    ctxs = [RunCtx()] + ([ep_ctx(drops)] if cfg.is_moe else [])
    tcaches = [cache_from_reference(cfg, jax.device_get(cache), device="cpu") for _ in ctxs]
    for t in range(PRIME, PRIME + STEPS):
        want, cache = step(tree, toks[:, t], t + offset, cache)
        for ctx, tcache in zip(ctxs, tcaches):
            got, _ = decode_step(params, cfg, torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(t + offset), tcache, ctx)
            assert got.dtype == torch.float32 and tuple(got.shape) == (B, cfg.vocab_size)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {t}",
                                       **tol)
    for tcache in tcaches:
        assert_trees_close(tcache, jax.device_get(cache), tol, f"{arch} cache")
    assert all(int(d.sum()) == 0 for d in drops)        # B = ep: one token a rank


def check_teacher_forced_decode_equals_forward(arch, S=12):
    """The port against itself: decode over a prompt gives ``forward``'s
    logits at every position (q_chunk 8, so the forward is chunked), and
    writes into the cache it was given."""
    cfg = decode_cfg(arch, "float32")
    params = init_params(cfg, 11, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, size=(B, S)))
    drops = []
    for mesh in [None] + ([ep_ctx(drops).mesh] if cfg.is_moe else []):
        full, _ = forward(params, cfg, {"tokens": toks}, RunCtx(q_chunk=8, mesh=mesh))
        cache = init_cache(cfg, B, S, device="cpu")
        leaves = jax.tree.leaves(cache)
        for t in range(S):
            lg, out = decode_step(params, cfg, toks[:, t], torch.full((B,), t), cache,
                                  RunCtx(mesh=mesh))
            assert all(a is b for a, b in zip(jax.tree.leaves(out), leaves))      # in place
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), err_msg=f"pos {t}",
                                       **TOL32)
    assert all(int(d.sum()) == 0 for d in drops)


@pytest.mark.parametrize("arch", [a for a in SERVED if a != "gemma3-27b"] + MOE)
def test_init_cache_tree_equals_the_reference(arch):
    check_cache_tree(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODE)
def test_decode_matches_reference(arch, dtype):
    check_decode_matches_reference(arch, dtype)


@pytest.mark.parametrize("arch", DECODE)
def test_teacher_forced_decode_equals_forward(arch):
    check_teacher_forced_decode_equals_forward(arch)


def test_decode_from_embeddings_matches_reference():
    """``embeds=`` [B, D] in place of tokens (Qwen1.5, fp32)."""
    cfg = decode_cfg("qwen1.5-4b", "float32")
    tree = ref_tree("qwen1.5-4b", "float32")
    step = RefJit(lambda p, e, pos, c: r_decode_step(p, cfg, None, pos, c, embeds=e))
    params = params_from_reference(cfg, tree, device="cpu")
    cache = r_init_cache(cfg, B, MAX_LEN)
    tcache = init_cache(cfg, B, MAX_LEN, device="cpu")
    emb = np.random.default_rng(9).standard_normal((4, B, cfg.d_model)).astype(np.float32)
    for t in range(4):
        pos = np.full((B,), t, np.int32)
        want, cache = step(tree, emb[t], pos, cache)
        got, tcache = decode_step(params, cfg, None, torch.from_numpy(pos), tcache,
                                  embeds=torch.from_numpy(emb[t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    assert_trees_close(tcache, jax.device_get(cache), TOL32, "embeds cache")


def test_decode_zero_stack_is_the_head_alone():
    cfg = decode_cfg("qwen1.5-4b", "float32")
    params = params_from_reference(cfg, ref_tree("qwen1.5-4b", "float32"), device="cpu")
    cache = init_cache(cfg, B, 4, device="cpu")
    tok = torch.tensor([3, 5])
    lg, out = decode_step(params, cfg, tok, torch.zeros(B, dtype=torch.long), cache,
                          RunCtx(n_units_override=0))
    assert torch.equal(lg, tlm._head(params, cfg, params["embed"][tok][:, None])[:, 0])
    assert out is cache and bool((cache["block"]["k"] == 0).all())


def test_position_past_the_cache_raises():
    """The reference's one-hot write drops a token at ``pos ≥ max_len`` and
    attends without it; the port's index write refuses it."""
    cfg = decode_cfg("qwen1.5-4b", "float32")
    params = params_from_reference(cfg, ref_tree("qwen1.5-4b", "float32"), device="cpu")
    cache = init_cache(cfg, B, 4, device="cpu")
    with pytest.raises(IndexError):
        decode_step(params, cfg, torch.tensor([1, 2]), torch.tensor([3, 4]), cache)
