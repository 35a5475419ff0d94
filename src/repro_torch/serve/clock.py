"""Clock abstraction for the serving stack.

The scheduler's queue/deadline/shed logic is clock-agnostic: it asks
"what time is it" and (in the real-clock front-end) "wait until t".
Factoring that question behind a protocol lets the *same* admission
queue, batch former, and deadline accounting run in two modes:

* :class:`VirtualClock` — time is driven externally by request arrival
  timestamps; nothing ever sleeps. This is the deterministic replay
  harness (:class:`repro_torch.serve.scheduler.ServingScheduler`) used by every
  test and virtual benchmark: batch composition and every counter depend
  only on the trace.
* :class:`MonotonicClock` — wall time from ``time.monotonic()``,
  rebased to 0 at construction so timestamps are small and directly
  comparable with virtual-clock traces. This is what the live
  front-end (:class:`repro_torch.serve.frontend.ServingFrontend`) runs on.

Both expose seconds as ``float``; all serving timestamps in this repo
are seconds since the clock's epoch (first arrival ≈ 0).

>>> c = VirtualClock()
>>> c.now()
0.0
>>> c.advance_to(1.5); c.now()
1.5
>>> c.advance_to(1.0); c.now()   # virtual time never goes backwards
1.5
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Minimal clock surface the serving stack depends on."""

    def now(self) -> float:
        """Current time in seconds since the clock's epoch."""
        ...

    def sleep(self, dt: float) -> None:
        """Block for ``dt`` seconds (no-op on a virtual clock)."""
        ...


class VirtualClock:
    """Externally-driven simulation clock (the replay test oracle).

    ``now()`` returns the largest timestamp ever passed to
    :meth:`advance_to` — the scheduler advances it with each arrival
    timestamp, so replaying the same trace always produces the same
    virtual timeline. ``sleep`` is a no-op: virtual time only moves via
    the trace.
    """

    def __init__(self, start_s: float = 0.0):
        self.now_s = float(start_s)

    def now(self) -> float:
        return self.now_s

    def advance_to(self, t: float) -> None:
        """Move time forward to ``t`` (monotone: earlier t is ignored)."""
        if t > self.now_s:
            self.now_s = float(t)

    def sleep(self, dt: float) -> None:     # pragma: no cover - trivial
        pass


class MonotonicClock:
    """Wall clock over ``time.monotonic()``, epoch-rebased to 0.

    >>> c = MonotonicClock()
    >>> t0 = c.now(); c.sleep(0.001); c.now() >= t0
    True
    """

    def __init__(self):
        self._epoch = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._epoch

    def advance_to(self, t: float) -> None:
        """No-op: wall time advances itself (kept so scheduler code can
        drive either clock uniformly)."""

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)
