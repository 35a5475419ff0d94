"""Collective accounting for the roofline.

The reference parses the collectives out of compiled HLO text. The port
has no HLO: a virtual-mesh step runs its ranks on one card, and what a
device mesh would send is index arithmetic there. So the records here
are derived from shapes, not parsed: a record is a list of (kind,
result bytes) pairs with the reference's kind names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``), and :func:`ring_collectives` /
:func:`moe_ep_collectives` give those that the ring search and the MoE
layer's expert parallelism stand in for on a device mesh.

``collective_bytes`` sums result bytes by kind and ``count_collectives``
counts them, as the reference's do over HLO; ``wire_bytes`` is the
reference's ring-algorithm estimate: exact for permutes and all-to-all,
(n−1)/n of an all-gather's gathered size, 2(n−1)/n of an all-reduce's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

Record = List[Tuple[str, int]]


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Result bytes summed by collective kind."""
    out: Dict[str, int] = defaultdict(int)
    for kind, nbytes in records:
        out[kind] += int(nbytes)
    return dict(out)


def count_collectives(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for kind, _ in records:
        out[kind] += 1
    return dict(out)


def wire_bytes(coll: Dict[str, int], n_shards: int) -> float:
    """Ring-algorithm wire-byte estimate per device from result bytes."""
    f = (n_shards - 1) / max(n_shards, 1)
    total = 0.0
    for kind, b in coll.items():
        if kind == "all-reduce":
            total += 2 * f * b
        elif kind in ("all-gather", "reduce-scatter"):
            total += f * b
        elif kind == "all-to-all":
            total += f * b
        elif kind == "collective-permute":
            total += b
    return total


def ring_collectives(scfg) -> Tuple[Record, Record]:
    """What one device (p, v, b) of the ring search's mesh sends in a step,
    as the reference's ``ring_chunk_search`` issues it: (per ring stage,
    once a step). Each of the n_chunks × B stages permutes the group's
    [QG, chunk] f32 accumulator and its [QG] τ round the ``model`` axis
    (none when B = 1); each step all-gathers the [QG, K] scores and ids
    over ``model``, the [qb, K] ones over ``data`` (V > 1) and over
    ``pod`` (pods > 1), and all-reduces its two tile counts over
    ``model`` and the [2] stats over ``data`` (and ``pod``)."""
    B, V, P, K = scfg.d_blocks, scfg.v_shards, scfg.n_pods, scfg.k
    qg, qb = scfg.qg, scfg.qb
    stage: Record = []
    if B > 1:
        stage = [("collective-permute", 4 * qg * scfg.chunk), ("collective-permute", 4 * qg)]
    step: Record = [("all-gather", 4 * B * qg * K)] * 2 + [("all-reduce", 4)] * 2 + [
        ("all-reduce", 8)]
    if V > 1:
        step += [("all-gather", 4 * V * qb * K)] * 2
    if P > 1:
        step += [("all-gather", 4 * P * qb * K)] * 2 + [("all-reduce", 8)]
    return stage, step


def moe_ep_collectives(cfg, batch_rows: int, seq: int, ep: int,
                       capacity_factor: float = 1.5, itemsize: int = 2) -> Record:
    """What one rank of ``moe_ffn_ep`` over ``ep`` ranks exchanges in one
    MoE layer, as the reference's shard_map layer issues it: the slots'
    rows [ep · cap_send, D] and their experts [ep · cap_send] int32 out,
    the expert outputs [ep · cap_send, D] back (three all-to-alls), and
    the aux loss's mean (an all-reduce of one f32). ``batch_rows`` is the
    rank's rows of the batch, ``itemsize`` the activations'."""
    from repro_torch.models.moe import ep_capacities

    cap_send, _ = ep_capacities(cfg, batch_rows * seq, ep, capacity_factor)
    rows, D = ep * cap_send, cfg.d_model
    return [("all-to-all", rows * D * itemsize), ("all-to-all", rows * 4),
            ("all-to-all", rows * D * itemsize), ("all-reduce", 4)]
