"""Worker-side fault sentinel: preemption, NaN, and stall handling (the
port's copy of ``frameworks/jax/sentinel.py``, behaviour unchanged).

The scheduler recovers *processes*; this module recovers *training runs*.
Three failure modes every long TPU job eventually meets, each with a
worker-local first response:

* **Preemption** (SIGTERM): Reservations are revoked with a grace
  window. The sentinel flips a flag; the training loop checks it between
  steps, flushes a sharded checkpoint, and exits cleanly — the relaunched
  incarnation resumes from that step instead of the last periodic save.
* **Non-finite loss**: one bad batch or a flaky interconnect reduction
  can poison the params. The loop rolls back to the newest
  ``save_sharded`` checkpoint (optimizer state included, so the LR
  schedule resumes exactly) and re-runs from there, up to a bounded
  number of rollbacks before giving up — crash-looping on a
  deterministically-bad step must still surface to the scheduler.
* **Stall**: a wedged collective (lost gang peer, hung host transfer)
  blocks inside one step forever, which no between-step check can see.
  A watchdog timer aborts the process so the scheduler's recovery plan
  takes over; a dead worker is recoverable, a silent one is not.

Env knobs (read by :meth:`FaultSentinel.from_env`):

* ``SENTINEL_STALL_S`` — seconds a single step may take before the
  watchdog aborts the process. ``0`` (default) disables the watchdog.
* ``SENTINEL_NAN_EVERY`` — check the loss for finiteness every N steps
  (each check syncs the device). ``1`` (default) checks every step;
  ``0`` disables.
* ``SENTINEL_MAX_ROLLBACKS`` — NaN rollbacks allowed per run before the
  loop raises (default ``3``).

Pure Python on purpose, so the loop logic is unit-testable with stub
step functions on any host (tests/test_torch_sentinel.py).
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
import threading
import time
from typing import Callable, Optional

STALL_EXIT_CODE = 74  # EX_IOERR: distinguishable from crash (1) and OOM kills


def _default_abort(step: int, stall_s: float) -> None:
    # os._exit, not sys.exit: the wedged step holds the main thread, and
    # an exception raised from this timer thread would go nowhere
    os._exit(STALL_EXIT_CODE)


class FaultSentinel:
    def __init__(self, stall_s: float = 0.0, nan_every: int = 1,
                 max_rollbacks: int = 3,
                 emit: Optional[Callable[[dict], None]] = None,
                 abort: Optional[Callable[[int, float], None]] = None):
        self.stall_s = stall_s
        self.nan_every = nan_every
        self.max_rollbacks = max_rollbacks
        self.preempted = False
        self._emit = emit or (lambda record: None)
        self._abort = abort or _default_abort
        self._prev_handler = None

    @classmethod
    def from_env(cls, emit: Optional[Callable[[dict], None]] = None,
                 env=os.environ) -> "FaultSentinel":
        return cls(stall_s=float(env.get("SENTINEL_STALL_S", "0") or 0),
                   nan_every=int(env.get("SENTINEL_NAN_EVERY", "1") or 0),
                   max_rollbacks=int(env.get("SENTINEL_MAX_ROLLBACKS", "3")),
                   emit=emit)

    # -- preemption --------------------------------------------------------

    def install(self) -> None:
        """Register the SIGTERM flag-flip. Safe to skip silently when not
        on the main thread (in-process test harnesses)."""
        def handler(signum, frame):
            self.preempted = True
            self._emit({"event": "sigterm", "action": "flush-and-exit"})
        try:
            self._prev_handler = signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread; preemption handling stays manual

    def uninstall(self) -> None:
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except ValueError:
                pass
            self._prev_handler = None

    # -- stall watchdog ----------------------------------------------------

    @contextlib.contextmanager
    def watch(self, step: int):
        """Arm the watchdog around one training step."""
        if not self.stall_s:
            yield
            return
        def fire():
            self._emit({"event": "stall", "step": step,
                        "stall_s": self.stall_s})
            self._abort(step, self.stall_s)
        timer = threading.Timer(self.stall_s, fire)
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            timer.cancel()

    # -- NaN policy --------------------------------------------------------

    def should_check_loss(self, step: int) -> bool:
        return self.nan_every > 0 and step % self.nan_every == 0


def guarded_loop(sentinel: FaultSentinel, start: int, steps: int,
                 run_step: Callable[[int], object],
                 loss_of: Callable[[object], float],
                 save: Callable[[int], None],
                 restore: Callable[[], Optional[int]],
                 emit: Optional[Callable[[dict], None]] = None
                 ) -> tuple[str, int]:
    """Drive ``run_step`` from ``start`` to ``steps`` under the sentinel.

    ``run_step(i)`` executes step ``i`` (mutating the caller's state via
    closure) and returns an opaque result; ``loss_of(result)`` materializes
    its loss (called only on checked steps — each call syncs the device).
    ``save(i)`` checkpoints the state as of ``i`` completed steps;
    ``restore()`` rolls state back to the newest checkpoint and returns
    its step, or None when there is nothing to roll back to.

    Returns ``(reason, next_step)`` where reason is ``"completed"`` or
    ``"preempted"`` and next_step is where a resumed run would continue.
    """
    emit = emit or (lambda record: None)
    rollbacks = 0
    i = start
    while i < steps:
        if sentinel.preempted:
            # stamp the SIGTERM flush receipt with the flushed step and
            # the wall-clock flush cost: the restart-free reshard A/B
            # (bench_r19/reshard.jsonl) needs a per-phase
            # checkpoint-restart baseline, not just aggregate tick counts
            t0 = time.monotonic()
            save(i)
            emit({"event": "preempted", "step": i, "flushed_step": i,
                  "flush_s": round(time.monotonic() - t0, 6)})
            return "preempted", i
        with sentinel.watch(i):
            result = run_step(i)
        if sentinel.should_check_loss(i):
            loss = loss_of(result)
            if loss is not None and not math.isfinite(loss):
                rollbacks += 1
                emit({"event": "nonfinite_loss", "step": i, "loss": repr(loss),
                      "rollback": rollbacks})
                if rollbacks > sentinel.max_rollbacks:
                    raise RuntimeError(
                        f"loss non-finite at step {i} after "
                        f"{sentinel.max_rollbacks} rollbacks — giving up so "
                        "the scheduler sees the crash-loop")
                t0 = time.monotonic()
                restored = restore()
                if restored is None:
                    raise RuntimeError(
                        f"loss non-finite at step {i} and no checkpoint to "
                        "roll back to")
                emit({"event": "rolled_back", "to_step": restored,
                      "restore_s": round(time.monotonic() - t0, 6)})
                i = restored
                continue
        i += 1
    return "completed", i
