"""The early stop across dimension blocks, served end to end on the CPU.

A clustered corpus (``perfbench/gen.py`` at a tiny size) is served through
``HarmonyServer(backend="spmd")`` over 1, 2 and 4 dimension blocks, with
pruning on and off. Every answer meets the plain reference of
``perfbench/references/ivf_flat.py`` within the tiny configuration's
limits, and pruning changes no answer. The executor counts, for stages
after the first, the tiles that the probe mask left live
(``tiles_after_mask``) and those that the τ test emptied
(``tiles_stopped``): none at one block or with pruning off, some at four
blocks with pruning on. The whole-mesh step still returns the
reference's two stats."""

import functools

import numpy as np
import pytest
import torch

from perfbench import gen, harness, tiny
from repro_torch import tracing
from repro_torch.config import HarmonyConfig
from repro_torch.core import build_ivf
from repro_torch.core import pipeline as tpipe
from repro_torch.core.index import assign_queries, preassign
from repro_torch.core.pruning import prewarm_tau
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.core.types import PartitionPlan
from repro_torch.serve import ExecutorConfig, HarmonyServer
from repro_torch.virtual_mesh import VirtualMesh

SEED = 2 ** 31 + 30
NQ = 96
# small tiles, so that a tile holds few live pairs and τ can empty it
TILES = dict(chunk=64, qb_buckets=(NQ,), tile_m=8, tile_n=32)


@functools.lru_cache(maxsize=None)
def inputs():
    cfg = tiny.tiny_config()
    cfg.update(dim=32, nlist=32, nprobe=4, k=5)
    inp = gen.make_inputs(cfg, SEED, torch.device("cpu"))
    q = next(gen.request_queries(cfg, dict(tiny.tiny_traffic(), queries_per_request=NQ),
                                 inp.centres, SEED, 0))
    hcfg = HarmonyConfig(dim=cfg["dim"], nlist=cfg["nlist"], nprobe=cfg["nprobe"],
                         topk=cfg["k"])
    index = build_ivf(inp.x.numpy(), hcfg, centers=inp.centroids.numpy(), device="cpu")
    return cfg, inp, q, index


@functools.lru_cache(maxsize=None)
def served(d_blocks: int, prune: bool):
    """(ids, scores, the executor's counters, the batch's span counts)."""
    cfg, _, q, index = inputs()
    srv = HarmonyServer(index, n_nodes=1, backend="spmd", device="cpu",
                        executor_cfg=ExecutorConfig(d_blocks=d_blocks, prune=prune, **TILES))
    tracing.drain()
    tracing.enable()
    try:
        res = srv.search_batch(q, cfg["k"])
    finally:
        tracing.disable()
    (sp,) = [s for s in tracing.drain() if s.name == "executor.search_batch"]
    return res.ids, res.scores, srv.executor.stats_summary(), sp.counts


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no_prune"])
@pytest.mark.parametrize("d_blocks", [1, 2, 4])
def test_served_answers_and_early_stop_counts(d_blocks, prune):
    cfg, inp, q, _ = inputs()
    ids, scores, summary, counts = served(d_blocks, prune)
    ref = harness.reference_module(tiny.ROOT, cfg)
    qs = torch.as_tensor(q)
    truth = ref.reference(inp.x, inp.centroids, qs, cfg["nprobe"], cfg["k"])
    numbers = ref.judge(inp.x, qs, truth, torch.arange(NQ), torch.as_tensor(ids),
                        torch.as_tensor(scores))
    checks, correct = harness.judge_limits(numbers, cfg["limits"])
    assert correct, checks

    # the early stop changes the work, never the answers
    other_ids, other_scores, _, _ = served(d_blocks, not prune)
    np.testing.assert_array_equal(ids, other_ids)
    np.testing.assert_array_equal(scores, other_scores)

    live, stopped = summary["tiles_after_mask"], summary["tiles_stopped"]
    assert (counts["tiles_after_mask"], counts["tiles_stopped"]) == (live, stopped)
    assert 0 <= stopped <= live
    if d_blocks == 1:
        assert live == stopped == 0
    else:
        assert live > 0
    if not prune:
        assert stopped == 0
    if d_blocks == 4 and prune:
        assert stopped > 0
    # every skip at a later stage is the mask's again or an early stop:
    # Σ skipped = B · (the mask's dead tiles) + stopped
    B, total = d_blocks, summary["tile_total"]
    if B > 1:
        mask_dead = total // B - live // (B - 1)
        assert summary["tile_skipped"] == B * mask_dead + stopped


@pytest.mark.parametrize("d_blocks", [1, 4])
def test_the_step_keeps_the_references_two_stats(d_blocks):
    cfg, _, q, index = inputs()
    plan = PartitionPlan(v_shards=1, d_blocks=d_blocks,
                         cluster_to_shard=load_aware_assignment(index.sizes, None, 1),
                         ring_offsets=ring_offsets(1, d_blocks))
    corpus = preassign(index, plan, pad_to=TILES["chunk"])
    scfg = tpipe.SpmdConfig(v_shards=1, d_blocks=d_blocks, qb=NQ, cap=corpus.cap,
                            dim=cfg["dim"], nprobe=cfg["nprobe"], k=cfg["k"],
                            chunk=TILES["chunk"], tile_m=TILES["tile_m"],
                            tile_n=TILES["tile_n"])
    probes = assign_queries(index, q)
    tau0 = prewarm_tau(index, q, probes, cfg["k"])
    arrays = tpipe.build_spmd_inputs(index, corpus, q, scfg, probes, tau0)
    names = ["x_blocks", "xn2_blocks", "cluster_ids", "row_ids", "queries", "probes", "tau0"]
    step = tpipe.make_spmd_search(scfg, VirtualMesh(1, model=d_blocks))
    _, _, stats = step(*(arrays[n] for n in names))
    assert stats.dtype == torch.int64 and stats.shape == (2,)
    # the ring's own stats carry the two counts after the reference's two
    res = tpipe.resident_arrays({n: arrays[n] for n in tpipe.CORPUS_OPERANDS}, scfg)
    _, _, ring = tpipe.ring_chunk_search(scfg, res["x_blk"], res["xn2_blk"],
                                         res["cluster_ids"], res["row_ids"],
                                         arrays["queries"], arrays["probes"], arrays["tau0"])
    assert ring.shape == (4,) and torch.equal(ring[:2], stats)
    assert 0 <= int(ring[3]) <= int(ring[2])
