"""Segment placement policy for the two-tier memory hierarchy.

This module decides *where each sealed segment's scoring arrays live*:

* ``device``: the executor keeps the segment's packed rows (int8 codes
  when serving int8, fp32 otherwise), block norms and id columns resident
  on the card, uploaded once per generation;
* ``host``: none of that is resident; per batch, only the probed
  clusters' rows are gathered on the host and copied to the card on a
  side stream (:class:`repro_torch.serve.executor.SpmdExecutor`,
  ``tier="host"``).

The policy is a greedy knapsack over *probe heat*: the data plane keeps a
per-segment cluster-hotness EWMA fed by every served batch's probe
selection (:meth:`repro_torch.core.SegmentedIndex.note_probes`); segments
are ranked by heat per device byte and packed into the budget hottest
first. A small hysteresis bonus keeps the incumbent device set sticky, so
a near-tie cannot flap a segment across PCIe every cycle.

Placement changes ride the same prepare → swap → adopt shape as a
compaction's generation swap (:func:`apply_placement`), so a tier move
drops no query: in-flight batches finish on the old residency, the next
batch picks up the new one. Results are tier-invariant by construction
(the host tier streams the same packed rows through the same kernels).

The budget is counted as the reference counts it
(:func:`repro_torch.core.index.segment_device_bytes`), and it is what
the card holds: each segment's fp32 ``IVFIndex.x`` is host memory
whatever its tier, so a ``host``-tier segment leaves nothing of its rows
on the card.

>>> import numpy as np
>>> from repro_torch.config import HarmonyConfig
>>> from repro_torch.core import SegmentedIndex
>>> rng = np.random.default_rng(0)
>>> cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3, kmeans_iters=2)
>>> data = SegmentedIndex.build(rng.standard_normal((64, 8)), cfg, device="cpu")
>>> data.upsert(np.arange(64, 96), rng.standard_normal((32, 8)))
>>> data.compact_inline()                    # seals the delta: 2 segments
>>> data.note_probes(0, np.array([[0, 1], [2, 3]]))   # heat on segment 0
>>> budget = 3 * sum(device_bytes_by_segment(data).values()) // 4
>>> tiers = plan_placement(data, PlacementConfig(device_budget_bytes=budget))
>>> tiers[0], tiers[1]
('device', 'host')
>>> plan_placement(data, PlacementConfig())           # no budget: all hot
{0: 'device', 1: 'device'}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from repro_torch.core.index import SegmentedIndex, segment_device_bytes
from repro_torch.runtime.faults import fault_point


@dataclass(frozen=True)
class PlacementConfig:
    """Knobs of the hotness-driven placement policy.

    ``device_budget_bytes`` is the card memory the corpus may occupy
    (None = unbounded, everything device-resident). ``precision`` is the
    budget currency: ``"int8"`` counts code bytes (4× more corpus per
    budget byte), ``"fp32"`` full rows. ``hysteresis`` is the
    relative heat bonus granted to currently-device segments so ties
    don't flap placement."""

    device_budget_bytes: Optional[int] = None
    precision: str = "fp32"
    d_blocks: int = 1
    hysteresis: float = 0.10


def device_bytes_by_segment(data: SegmentedIndex,
                            precision: str = "fp32",
                            d_blocks: int = 1) -> Dict[int, int]:
    """seg_id -> card bytes of keeping that segment device-resident."""
    return {s.seg_id: segment_device_bytes(s, precision, d_blocks)
            for s in data.segments}


def plan_placement(data: SegmentedIndex,
                   cfg: PlacementConfig) -> Dict[int, str]:
    """Greedy heat-per-byte knapsack: every sealed segment gets a tier,
    hottest-per-device-byte first until the budget is spent. Fully
    deterministic: ties break by segment id, and the incumbent device
    set gets a ``hysteresis`` heat bonus so a stable workload yields a
    stable placement."""
    costs = device_bytes_by_segment(data, cfg.precision, cfg.d_blocks)
    if cfg.device_budget_bytes is None:
        return {sid: "device" for sid in costs}
    heat = data.segment_hotness()
    current = data.tiers()
    scored = []
    for sid, cost in costs.items():
        h = heat.get(sid, 0.0)
        if current.get(sid, "device") == "device":
            h *= 1.0 + cfg.hysteresis
        # heat density: probe mass bought per device byte. The +1 floor
        # keeps never-probed segments ordered (small first) and nonzero.
        scored.append(((h + 1.0) / max(cost, 1), sid, cost))
    scored.sort(key=lambda t: (-t[0], t[1]))
    out: Dict[int, str] = {}
    budget = int(cfg.device_budget_bytes)
    for _, sid, cost in scored:
        if cost <= budget:
            out[sid] = "device"
            budget -= cost
        else:
            out[sid] = "host"
    return out


def apply_placement(data: SegmentedIndex, servers: Sequence,
                    tiers: Dict[int, str]) -> bool:
    """Install ``tiers`` across the data plane and every serving replica
    with the compaction swap's zero-downtime shape:

    1. *prepare* — each server pre-builds executor state for the
       segments whose tier changes, off the serving path;
    2. *swap* — the data plane's tier map flips atomically
       (``placement_version`` bump);
    3. *adopt* — each server promotes its staged states.

    A crash between (2) and (3) (fault site ``"placement.swap"``) is
    harmless: servers that missed the adopt re-sync lazily on their next
    batch because the snapshot carries ``placement_version`` — a segment
    is never unreachable, at worst one batch rebuilds residency inline.
    Returns False when ``tiers`` is already the current placement."""
    if tiers == data.tiers():
        return False
    fault_point("placement.prepare")
    for srv in servers:
        prep = getattr(srv, "prepare_placement", None)
        if prep is not None:
            prep(tiers)
    data.set_tiers(tiers)
    fault_point("placement.swap")
    for srv in servers:
        adopt = getattr(srv, "adopt", None)
        if adopt is not None:
            adopt()
    return True
