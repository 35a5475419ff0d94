"""The port's recurrent families (xLSTM, Zamba2) through the LM entry points
against ``repro.models`` on the CPU.

On both smoke configs, with the reference's own ``init_params`` /
``init_cache`` carried across as numpy: ``forward`` and ``prefill`` (S = 13,
``rec_chunk=4``: four chunks, the last padded), three decode steps of the
reference then eight in both packages from the carried cache (every
step's logits and the final caches), the init and cache trees; at
rtol = atol = 1e-4 in fp32 and ``BF16_TOL`` in bf16, the reference under
``RefJit`` (xLSTM's bf16 forward logits: ``BF16_TOL`` but where the
reference misses it against itself, see ``assert_logits_close``). The
port's teacher-forced decode equals its own ``forward``
(``tests/models/test_archs_smoke.py::test_recurrent_decode_matches_forward``),
a greedy bf16 decode stays finite (``::test_decode_smoke``), and its bf16
decode drifts from ``forward`` no more than the reference's does.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import RunCtx as RRunCtx
from repro.models import decode_step as r_decode_step
from repro.models import forward as r_forward
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro_torch import configs as tcfgs
from repro_torch.models import (
    RunCtx,
    cache_from_reference,
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_reference,
    prefill,
)
from test_torch_lm import BF16_TOL, TOL32, RefJit, fp32, ref_tree
from test_torch_lm_decode import assert_trees_close

RECURRENT = ["xlstm-1.3b", "zamba2-2.7b"]
B, S, REC_CHUNK = 2, 13, 4
MAX_LEN, PRIME, STEPS = 16, 3, 8


def cfg_of(arch, dtype):
    cfg = rcfgs.get_smoke_config(arch)
    return fp32(cfg) if dtype == "float32" else cfg


def tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def ref_forward(cfg, rec_chunk):
    return RefJit(lambda p, t: r_forward(p, cfg, {"tokens": t}, RRunCtx(rec_chunk=rec_chunk))[0])


def assert_logits_close(got, want, want_alt, tol):
    """``got`` against ``want`` at ``tol``. In bf16 the reference itself
    misses ``BF16_TOL`` on xLSTM's logits under a change of ``rec_chunk``,
    which the algebra makes a no-op (``want_alt``): 11 of 13,312 logits,
    by up to 0.125 at |logit| ≤ 45.25 (its tied, unscaled embedding
    carries a last-bit change of the final hidden state into the logits).
    So the port may miss ``tol`` at no more logits, and by no more, than
    the reference misses it against itself; where the reference holds
    ``tol`` against itself (Zamba2, and fp32), this is ``tol`` alone."""
    miss = ~np.isclose(got, want, **tol)
    own_miss = ~np.isclose(want_alt, want, **tol)
    if not own_miss.any():
        np.testing.assert_allclose(got, want, **tol)
        return
    assert miss.sum() <= own_miss.sum(), (miss.sum(), own_miss.sum())
    assert np.abs(got - want).max() <= np.abs(want_alt - want).max()


@functools.lru_cache(maxsize=None)
def ref_decode(cfg):
    return RefJit(lambda p, tok, pos, cache: r_decode_step(p, cfg, tok, pos, cache))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_and_prefill_match_reference(arch, dtype):
    cfg = cfg_of(arch, dtype)
    tol = TOL32 if dtype == "float32" else BF16_TOL
    tree = ref_tree(arch, dtype)
    toks = tokens(cfg, S, 0)
    want = np.asarray(ref_forward(cfg, REC_CHUNK)(tree, toks))
    want_one = np.asarray(ref_forward(cfg, S)(tree, toks))            # one chunk
    params = params_from_reference(cfg, tree, device="cpu")
    ctx = RunCtx(rec_chunk=REC_CHUNK)
    got, aux = forward(params, cfg, {"tokens": torch.from_numpy(toks)}, ctx)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    assert_logits_close(got.numpy(), want, want_one, tol)
    last = prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, ctx)
    assert torch.equal(last, got[:, -1])
    # RunCtx.rec_chunk as the reference's: one chunk against its one chunk
    whole, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)}, RunCtx(rec_chunk=128))
    assert_logits_close(whole.numpy(), want_one, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_matches_reference(arch, dtype):
    """Three reference steps fill a cache (tuples and all), carried across
    by ``cache_from_reference``; eight steps then run in both packages (a
    row one position ahead of the other)."""
    cfg = cfg_of(arch, dtype)
    tol = TOL32 if dtype == "float32" else BF16_TOL
    tree = ref_tree(arch, dtype)
    step = ref_decode(cfg)
    toks = tokens(cfg, PRIME + STEPS, 7)
    offset = np.arange(B, dtype=np.int32)
    cache = r_init_cache(cfg, B, MAX_LEN)
    for t in range(PRIME):
        _, cache = step(tree, toks[:, t], t + offset, cache)
    params = params_from_reference(cfg, tree, device="cpu")
    carried = jax.device_get(cache)
    snapshot = jax.tree.map(np.array, carried)                      # copies
    tcache = cache_from_reference(cfg, carried, device="cpu")
    leaves = jax.tree.leaves(tcache)
    for t in range(PRIME, PRIME + STEPS):
        want, cache = step(tree, toks[:, t], t + offset, cache)
        got, out = decode_step(params, cfg, torch.from_numpy(toks[:, t]),
                               torch.from_numpy(t + offset), tcache)
        assert out is tcache and all(a is b for a, b in zip(jax.tree.leaves(out), leaves))
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {t}", **tol)
    assert_trees_close(tcache, jax.device_get(cache), tol, f"{arch} cache")
    # the carried-in arrays are the caller's: the in-place decode left them alone
    for a, b in zip(jax.tree.leaves(carried), jax.tree.leaves(snapshot)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_cache_tree_equals_the_reference(arch):
    """Keys, tuples, shapes and dtypes of ``init_cache``; zeros but the
    sLSTM's ``n``, which starts at 1."""
    cfg = rcfgs.get_smoke_config(arch)
    want = jax.device_get(r_init_cache(cfg, B, MAX_LEN))
    got = init_cache(cfg, B, MAX_LEN, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, want))
    assert_trees_close(got, want, dict(rtol=0, atol=0), f"{arch} init_cache")


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_params_has_the_reference_tree(arch):
    cfg = rcfgs.get_smoke_config(arch)
    want = jax.eval_shape(lambda k: r_init_params(cfg, k), jax.random.PRNGKey(0))
    got = init_params(cfg, 0, device="cpu")
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for key, leaf in flat_w.items():
        assert tuple(flat_g[key].shape) == tuple(leaf.shape), key
        assert str(flat_g[key].dtype).replace("torch.", "") == str(leaf.dtype), key


@pytest.mark.parametrize("arch", RECURRENT)
def test_teacher_forced_decode_equals_forward(arch):
    """The port against itself (fp32, its own seeded init): decode over a
    prompt gives ``forward``'s logits (four-step chunks) at every
    position, writing into the cache it was given."""
    cfg = cfg_of(arch, "float32")
    params = init_params(cfg, 11, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 12, 8)).long()
    full, _ = forward(params, cfg, {"tokens": toks}, RunCtx(rec_chunk=REC_CHUNK))
    cache = init_cache(cfg, B, 12, device="cpu")
    leaves = jax.tree.leaves(cache)
    for t in range(12):
        lg, out = decode_step(params, cfg, toks[:, t], torch.full((B,), t), cache)
        assert all(a is b for a, b in zip(jax.tree.leaves(out), leaves))
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), err_msg=f"pos {t}", **TOL32)


def test_bf16_decode_drift_matches_the_reference():
    """In bf16 an xLSTM's teacher-forced decode drifts from its own chunked
    ``forward`` as rounding compounds through the recurrences: the
    reference's as much as the port's. At the smoke width with 16 layers
    over 32 tokens, the port's largest |decode − forward| is at most
    1.5× the reference's own (and the reference's is not 0: the drift is
    there to compare)."""
    cfg = rcfgs.get_smoke_config("xlstm-1.3b").replace(num_layers=16)
    tree = jax.device_get(r_init_params(cfg, jax.random.PRNGKey(0)))
    n = 32
    toks = tokens(cfg, n, 1)
    want_fwd = np.asarray(RefJit(lambda p, t: r_forward(p, cfg, {"tokens": t})[0])(tree, toks))
    step = RefJit(lambda p, tok, pos, cache: r_decode_step(p, cfg, tok, pos, cache))
    cache = r_init_cache(cfg, B, n)
    want_dec = []
    for t in range(n):
        lg, cache = step(tree, toks[:, t], np.full((B,), t, np.int32), cache)
        want_dec.append(np.asarray(lg))
    ref_drift = float(np.abs(np.stack(want_dec, 1) - want_fwd).max())
    params = params_from_reference(cfg, tree, device="cpu")
    got_fwd, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    tcache = init_cache(cfg, B, n, device="cpu")
    got_dec = torch.stack([decode_step(params, cfg, torch.from_numpy(toks[:, t]),
                                       torch.full((B,), t), tcache)[0] for t in range(n)], 1)
    drift = float((got_dec - got_fwd).abs().max())
    assert ref_drift > 0 and drift <= 1.5 * ref_drift, (drift, ref_drift)


@pytest.mark.parametrize("arch", RECURRENT)
def test_greedy_decode_smoke(arch):
    """``test_decode_smoke`` through the port: the bf16 smoke model from its
    seeded init, four greedy steps from token 0, finite logits."""
    cfg = tcfgs.get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    cache = init_cache(cfg, B, 16, device="cpu")
    tok = torch.zeros((B,), dtype=torch.long)
    for t in range(4):
        lg, cache = decode_step(params, cfg, tok, torch.full((B,), t), cache)
        tok = lg.argmax(-1)
    assert tuple(lg.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(lg).all())


def test_recurrent_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in RECURRENT:
        cfg = tcfgs.get_smoke_config(arch)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_cache(cfg, B, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            cache_from_reference(cfg, jax.device_get(r_init_cache(cfg, B, 8)))


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("xlstm-1.3b", 8), ("zamba2-2.7b", 6)])
def test_cuda_full_width_forward_matches_cpu(arch, layers):
    """Each model at its published width, one unit, fp32: the card's logits
    against the CPU's on the same params (TF32 off) at 1e-3, over four
    16-step chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.lm import map_tree

    cfg = fp32(tcfgs.get_config(arch)).replace(num_layers=layers)
    params = init_params(cfg, 0, device="cuda")
    cpu = map_tree(params, lambda t: t.cpu())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 64)))
    got, _ = forward(params, cfg, {"tokens": toks.cuda()}, RunCtx(rec_chunk=16))
    want, _ = forward(cpu, cfg, {"tokens": toks}, RunCtx(rec_chunk=16))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-3)
