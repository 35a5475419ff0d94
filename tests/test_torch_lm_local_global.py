"""Gemma3's local:global pattern through the port against ``repro.models``
on the CPU: one unit of 5 sliding-window layers and a global one, then 2
tail locals, with tied and √d-scaled embeddings. ``forward`` / ``prefill``
(fp32 at 1e-4, bf16 at ``BF16_TOL``), the ring-buffer caches, and decode
past the window: the smoke config's window shrunk to 8, so the ring wraps
during the run (the test bodies are ``test_torch_lm*.py``'s)."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import RunCtx as RRunCtx
from repro_torch.models import RunCtx, forward, params_from_reference
from test_torch_lm import (
    TOL32,
    check_forward_and_prefill,
    fp32,
    np32,
    np_batch,
    ref_forward,
    ref_tree,
    to_jax,
    to_torch,
)
from test_torch_lm_decode import (
    check_cache_tree,
    check_decode_matches_reference,
    check_teacher_forced_decode_equals_forward,
)

ARCH = "gemma3-27b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_reference(dtype):
    check_forward_and_prefill(ARCH, dtype)


def test_init_cache_tree_equals_the_reference():
    check_cache_tree(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_past_the_window_matches_reference(dtype):
    check_decode_matches_reference(ARCH, dtype)


def test_teacher_forced_decode_equals_forward():
    check_teacher_forced_decode_equals_forward(ARCH)


def test_forward_n_units_override_zero_skips_the_stack():
    cfg = fp32(rcfgs.get_smoke_config(ARCH))
    tree = ref_tree(ARCH, "float32")
    batch = np_batch(cfg, S=8)
    want, _ = ref_forward(cfg, RRunCtx(n_units_override=0))(tree, to_jax(batch))
    got, _ = forward(params_from_reference(cfg, tree, device="cpu"), cfg, to_torch(batch),
                     RunCtx(n_units_override=0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_carries_bits_and_keys(dtype):
    """Tied embeddings, stacked locals and tail locals keep the reference's
    keys, dtypes and bits (bf16 through its 16-bit words)."""
    cfg = rcfgs.get_smoke_config(ARCH)
    tree = ref_tree(ARCH, dtype)
    got = params_from_reference(cfg, tree, device="cpu")
    flat_w = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for key, leaf in flat_w.items():
        t = flat_g[key]
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), key
        assert np.array_equal(np32(t), np.asarray(leaf, np.float32)), key
    if dtype == "bfloat16":
        assert got["embed"].dtype == torch.bfloat16
        assert np.array_equal(got["embed"].view(torch.int16).numpy(),
                              np.asarray(tree["embed"]).view(np.int16))
