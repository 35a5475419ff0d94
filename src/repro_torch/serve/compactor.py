"""Background compaction for the mutable segmented data plane.

The :class:`repro_torch.core.SegmentedIndex` absorbs writes into a small
append-only delta buffer and tombstone bitmaps; left alone, the delta's
brute-force scan and the dead rows' wasted residency would tax every
query. The :class:`Compactor` keeps both bounded, off the serving path:

* **seal**: when the delta reaches ``delta_threshold`` live rows, seal it
  into a new sealed segment (k-means and pack on the plane's device, the
  expensive step, runs without the data-plane lock; writes that land
  meanwhile are journaled and replayed at commit);
* **merge**: when the sealed segment count exceeds ``max_segments`` or
  the tombstoned fraction exceeds ``max_dead_fraction``, re-seal *all*
  live rows into one fresh segment (dead rows dropped, tombstones reset).
  A full merge equals ``build_ivf`` over the live set (the port's k-means
  is seeded from numpy, so its centres differ from the reference's).

Swap protocol (no dropped query):

1. ``begin_compaction`` snapshots the rows to re-seal and starts the
   write journal; serving continues on the old segments;
2. ``seal`` builds the new segment(s): long, lock-free;
3. every live replica ``prepare_segments``: plans and warmed executors
   are built into a staging area, so the swap itself is O(1);
4. ``commit_compaction`` installs the new segment set, replays the
   journal, and bumps the generation;
5. every live replica adopts the new generation (a replica that
   missed this call adopts on its next batch). The retired segments'
   executors, and so their card memory, go with the adopt.

A query admitted at any point during 1–5 is answered, exactly, by
whichever generation its batch snapshotted.

The compactor runs on the plane's device. Its background thread makes
that device current before any work (seal, warm-up), so CUDA work it
issues never lands on another card.

>>> import numpy as np
>>> from repro_torch.config import HarmonyConfig
>>> from repro_torch.core import SegmentedIndex
>>> from repro_torch.serve import HarmonyServer
>>> from repro_torch.serve.compactor import CompactionConfig, Compactor
>>> rng = np.random.default_rng(0)
>>> cfg = HarmonyConfig(dim=8, nlist=4, nprobe=4, topk=3, kmeans_iters=2)
>>> data = SegmentedIndex.build(
...     rng.standard_normal((128, 8)).astype(np.float32), cfg, device="cpu")
>>> srv = HarmonyServer(data, n_nodes=2, device="cpu")
>>> comp = Compactor(data, srv, CompactionConfig(delta_threshold=4),
...                  device="cpu")
>>> srv.upsert(np.arange(128, 134), rng.standard_normal((6, 8)))
>>> event = comp.maybe_compact()
>>> event["reason"], event["generation"], data.delta_len, data.n_segments
('delta_full', 1, 0, 2)
>>> q = data.segments[-1].index.x[:1].numpy()
>>> int(srv.search_batch(q, k=1).ids[0, 0]) >= 128
True
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch._device import DeviceLike, bind_device, resolve_device
from repro_torch.core import SegmentedIndex
from repro_torch.runtime.faults import fault_point
from repro_torch.serve.placement import (
    PlacementConfig,
    apply_placement,
    plan_placement,
)


@dataclass(frozen=True)
class CompactionConfig:
    """Compaction policy knobs.

    ``delta_threshold`` — live delta rows that trigger a seal;
    ``max_segments`` — sealed segment count that triggers a full merge;
    ``max_dead_fraction`` — tombstoned fraction of sealed rows that
    triggers a full merge; ``poll_s`` — background thread poll interval
    (seconds); ``placement`` — optional
    :class:`repro_torch.serve.placement.PlacementConfig`: when set, the
    compactor also owns tier placement — it re-plans the hot/cold split
    after every commit (new segments are born unplaced) and whenever
    :meth:`Compactor.maybe_place` sees the hotness-driven plan drift
    from the installed one."""

    delta_threshold: int = 1024
    max_segments: int = 4
    max_dead_fraction: float = 0.25
    poll_s: float = 0.05
    placement: Optional[PlacementConfig] = None


class Compactor:
    """Seals/merges a :class:`~repro_torch.core.SegmentedIndex` and
    hot-swaps the result into live replicas.

    ``servers`` is the set of replicas to prepare/adopt around each
    commit: a single ``HarmonyServer``, an object with ``live_servers()``
    (re-resolved on every cycle), an explicit sequence of servers, or
    ``None`` (replicas then adopt on their next batch). ``device`` is the
    plane's device (CUDA by default; the plane must live there). Use
    :meth:`maybe_compact` from a scheduler hook or a test, or
    :meth:`start` for a background thread. ``events`` records one dict
    per completed compaction."""

    def __init__(
        self,
        data: SegmentedIndex,
        servers=None,
        cfg: Optional[CompactionConfig] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if data.device != self.device:
            raise ValueError(f"the data plane lives on {data.device}, "
                             f"the compactor on {self.device}")
        self.data = data
        self.cfg = cfg or CompactionConfig()
        self._servers_arg = servers
        self.events: List[Dict] = []
        self.errors: List[str] = []         # failed background cycles
        self._op_mu = threading.Lock()      # one compaction cycle at a time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- targets
    def _servers(self) -> Sequence:
        s = self._servers_arg
        if s is None:
            return ()
        if hasattr(s, "live_servers"):          # a fleet of replicas
            return s.live_servers()
        if hasattr(s, "prepare_segments"):      # single HarmonyServer
            return (s,)
        return tuple(s)

    # -------------------------------------------------------------- policy
    def should_compact(self) -> Optional[str]:
        """Why a compaction is due now, or None. ``"delta_full"`` seals
        the delta; ``"too_many_segments"``/``"dead_heavy"`` full-merge."""
        cfg = self.cfg
        if self.data.n_segments > cfg.max_segments:
            return "too_many_segments"
        sealed = sum(s.nb for s in self.data.segments)
        dead = sum(self.data.dead_count_by_segment().values())
        if sealed and dead / sealed > cfg.max_dead_fraction:
            return "dead_heavy"
        if self.data.delta_len >= cfg.delta_threshold:
            # sealing the delta would push the segment count over the
            # bound anyway: merge instead of seal-then-merge
            if self.data.n_segments >= cfg.max_segments:
                return "too_many_segments"
            return "delta_full"
        return None

    # ------------------------------------------------------------- cycles
    def run_once(self, merge_all: bool = False, reason: str = "manual") -> Dict:
        """One full begin → seal → prepare → commit → adopt cycle.
        Serving is never paused; a concurrent cycle is waited out (the
        data plane itself raises only if ``begin_compaction`` races a
        non-Compactor caller)."""
        with self._op_mu:
            return self._run_once_locked(merge_all, reason)

    def _run_once_locked(self, merge_all: bool, reason: str) -> Dict:
        t0 = time.perf_counter()
        plan = self.data.begin_compaction(merge_all=merge_all)
        # the named fault sites sit BETWEEN the phases, outside the abort
        # handler on purpose: an InjectedFault there simulates the process
        # dying at that boundary, so the aftermath (open journal, staged-
        # but-uncommitted segments, committed-but-unadopted generation) is
        # exactly a kill's — :meth:`recover` is what cleans it up. A real
        # failure *inside* seal/prepare still aborts as before.
        fault_point("compactor.begin", reason=reason)
        t_seal = time.perf_counter()
        try:
            segments = self.data.seal(plan)
        except BaseException:
            self.data.abort_compaction()
            raise
        fault_point("compactor.seal", reason=reason)
        t_prepare = time.perf_counter()
        try:
            for srv in self._servers():
                srv.prepare_segments(segments)
        except BaseException:
            self.data.abort_compaction()
            raise
        fault_point("compactor.prepare", reason=reason)
        t_commit = time.perf_counter()
        generation = self.data.commit_compaction(plan, segments)
        fault_point("compactor.commit", reason=reason)
        t_adopt = time.perf_counter()
        for srv in self._servers():
            srv.adopt()
        placed = self._place_locked()
        t_end = time.perf_counter()
        event = {
            "reason": reason,
            "generation": generation,
            "merge_all": merge_all,
            "sealed_rows": int(plan.ids.size),
            "merged_segments": len(plan.merge_seg_ids),
            "carried_segments": len(plan.carry_seg_ids),
            "new_segments": len(segments),
            "segments_after": self.data.n_segments,
            "placed": placed,
            "wall_s": t_end - t0,
            # the phases' host walls (the port's own; the seal's k-means and
            # the executors' warm-up end by reading results back)
            "seal_s": t_prepare - t_seal,
            "prepare_s": t_commit - t_prepare,
            "commit_s": t_adopt - t_commit,
            "adopt_s": t_end - t_adopt,
        }
        self.events.append(event)
        return event

    # ----------------------------------------------------------- placement
    def _place_locked(self) -> bool:
        pcfg = self.cfg.placement
        if pcfg is None:
            return False
        tiers = plan_placement(self.data, pcfg)
        return apply_placement(self.data, self._servers(), tiers)

    def maybe_place(self) -> Optional[Dict]:
        """Re-run the hotness-driven placement policy and install the
        plan if it drifted from the current tiers (no-op otherwise; also
        a no-op without ``cfg.placement``). Like :meth:`maybe_compact`,
        safe to call from scheduler hooks at any frequency — the swap is
        zero-downtime and results are tier-invariant."""
        if self.cfg.placement is None:
            return None
        with self._op_mu:
            if not self._place_locked():
                return None
            event = {
                "reason": "placement",
                "tiers": dict(self.data.tiers()),
                "placement_version": self.data.placement_version,
            }
            self.events.append(event)
            return event

    def maybe_compact(self) -> Optional[Dict]:
        """Run one cycle if the policy says so (no-op otherwise). Safe to
        call from scheduler hooks at any frequency. The policy is
        re-evaluated *after* acquiring the cycle lock — a call that
        queued behind another cycle must not execute that cycle's stale
        decision (e.g. a second full merge of an already-merged plane)."""
        if self.should_compact() is None:       # cheap pre-check, no lock
            return None
        with self._op_mu:
            reason = self.should_compact()
            if reason is None:
                return None
            return self._run_once_locked(
                merge_all=(reason != "delta_full"), reason=reason
            )

    # ------------------------------------------------------ crash recovery
    def recover(self) -> Dict:
        """Bring the plane back to a clean compactable state after a
        crash mid-cycle (or on any restart — a no-op when clean).

        The crash matrix, by the phase boundary the cycle died at:

        * **begin/seal/prepare** (journal open, nothing committed) —
          roll back: ``abort_compaction`` closes the journal. Nothing is
          lost — begin only *snapshots* rows, so every write is still
          live in the delta/tombstone state, and the sealed-but-never-
          committed segments are garbage by construction;
        * **commit** (generation bumped, replicas not yet told) —
          roll forward: every live server ``adopt``\\ s the committed
          generation (they would also self-heal lazily on their next
          batch). Adopt also prunes any staged-but-never-committed
          segment state a prepare-phase crash parked on a server.

        Returns ``{"rolled_back": bool, "adopted": [...], "generation"}``.
        """
        rolled_back = False
        with self._op_mu:
            if self.data.compaction_in_flight:
                self.data.abort_compaction()
                rolled_back = True
            adopted = []
            for srv in self._servers():
                if srv.generation != self.data.generation:
                    adopted.append(srv.generation)
                srv.adopt()
        report = {
            "rolled_back": rolled_back,
            "adopted": adopted,
            "generation": self.data.generation,
        }
        self.events.append({"reason": "recover", **report})
        return report

    # ---------------------------------------------------------- background
    def start(self) -> "Compactor":
        """Start the background thread (idempotent); pair with
        :meth:`stop` or use as a context manager."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="harmony-compactor", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        # the seal's k-means and the executors' warm-up run here, on the
        # plane's card, whatever device the starting thread had
        bind_device(self.device)
        while not self._stop.is_set():
            try:
                self.maybe_compact()
                self.maybe_place()
            except Exception as e:      # noqa: BLE001 - must not die silently
                # a failed cycle (seal/prepare/commit error) is recorded
                # and surfaced, never swallowed — the loop keeps serving
                # the compaction policy, but an operator can see why the
                # delta is growing
                self.errors.append(repr(e))
                warnings.warn(f"background compaction failed: {e!r}")
            self._stop.wait(self.cfg.poll_s)

    def stop(self, timeout: float = 30.0) -> bool:
        """Signal the loop and join. Returns True once the thread is down.

        On a join timeout the handle is *kept* (dropping it would leak a
        live thread that :meth:`start` could then duplicate, and the
        stop event it still polls could be cleared under it) and the
        failure is recorded in ``self.errors`` — call again to re-join."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout)
        if t.is_alive():
            self.errors.append(
                f"stop(): compactor thread still alive after {timeout}s join"
            )
            return False
        self._thread = None
        return True

    def __enter__(self) -> "Compactor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
