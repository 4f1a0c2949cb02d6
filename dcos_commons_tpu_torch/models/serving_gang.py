"""Multi-process (gang) serving: the rank-0 request broadcast (port of
``dcos_commons_tpu/models/serving_gang.py``).

A tensor-parallel gang (one process a device, ``parallel.mesh``) runs in
lock-step: every process must make the SAME engine calls with the SAME
values, or the collectives inside them diverge. So a per-process HTTP
front door cannot drive the engine directly:

* Rank 0 runs the front door (``models.ingress.ServingFrontend``,
  started with ``drive=False``); the other ranks run nothing
  client-facing.
* Every rank runs :meth:`GangServingDriver.run`'s loop. Each iteration
  rank 0 drains up to ``min(free slots, max_intake)`` queued requests
  into a FIXED-SHAPE int32 intake array, which :meth:`Mesh.broadcast_array
  <dcos_commons_tpu_torch.parallel.mesh.Mesh.broadcast_array>` sends to
  every rank; every rank decodes it and makes the same
  ``engine.submit_many`` call (the slot choice is deterministic: the
  first free slots), then the same ``engine.step_many``. Rank 0 fans the
  tokens out to its clients; the peers drop them.
* The broadcast is the rendezvous: an idle iteration still broadcasts an
  empty intake, so no rank waits on a collective the others skipped.

Determinism: greedy decoding, or a sampler with the same generator seed
on every rank, and no engine decision taken from wall time, thread
timing or a per-rank draw; the engines' mesh refusals (under tp, ep and
sp alike) keep the paths that would (the KV tiers' staleness, a draft)
out of a gang.

Ring prefill rides the loop unchanged: a ``PagedServer`` armed with
``longctx_ring`` over an sp gang decides ring or chunks from host state
that is the same on every rank (the prompt's length and prefill
position), so every rank enters the same ``llama.prefill_ring`` in the
same iteration; the sequence-parallel prefill is one more lock-step
dispatch. Its one fallback (a padded length over ``max_seq``) is a pure
function of the broadcast intake. A ring that fails after its first
collective raises ``RingPrefillError``, which :meth:`GangServingDriver.
run` does not catch: the replica fails loudly instead of meeting peers
that may still wait inside the ring. The heartbeat's ``pages.longctx``
shows the ring's counters, ``fallbacks`` among them.

Wire format (:func:`encode_intake` / :func:`decode_intake`): int32
``[max_intake, 2 + max_prompt]``; a row is (prompt_len, max_new,
prompt..., 0 padding); prompt_len 0 ends the list.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np

from .ingress import ServingFrontend, _Pending
from .serving import RingPrefillError


def encode_intake(items: List[Tuple[List[int], int]], max_intake: int,
                  max_prompt: int) -> np.ndarray:
    """[(prompt, max_new), ...] -> fixed-shape int32 intake array."""
    if len(items) > max_intake:
        raise ValueError(f"{len(items)} submissions > max_intake "
                         f"{max_intake}")
    arr = np.zeros((max_intake, 2 + max_prompt), np.int32)
    for i, (prompt, max_new) in enumerate(items):
        n = len(prompt)
        if not 0 < n <= max_prompt:
            raise ValueError(f"prompt length {n} not in (0, {max_prompt}]")
        arr[i, 0] = n
        arr[i, 1] = max_new
        arr[i, 2:2 + n] = prompt
    return arr


def decode_intake(arr: np.ndarray) -> List[Tuple[List[int], int]]:
    out = []
    for row in np.asarray(arr):
        n = int(row[0])
        if n == 0:
            break
        out.append(([int(t) for t in row[2:2 + n]], int(row[1])))
    return out


class GangServingDriver:
    """The lock-step serving loop of one gang member.

    Rank 0 passes its :class:`ServingFrontend` (started with
    ``drive=False``); the peers pass ``frontend=None``. Every rank passes
    an engine built the same way (``SlotServer`` or ``PagedServer``, the
    same seed) over the same ``mesh``; the intake crosses by
    ``mesh.broadcast_array`` (no mesh: a gang of one).
    """

    def __init__(self, engine, frontend: Optional[ServingFrontend], *,
                 num_processes: int, process_id: int, mesh: Any = None,
                 decode_window: int = 8, max_intake: int = 4,
                 max_prompt: Optional[int] = None,
                 idle_sleep_s: float = 0.02):
        if (frontend is not None) != (process_id == 0):
            raise ValueError("exactly rank 0 owns the HTTP frontend")
        if num_processes > 1 and (mesh is None
                                  or mesh.size != num_processes):
            raise ValueError(f"a gang of {num_processes} processes needs "
                             f"its mesh (got {mesh!r})")
        self.engine = engine
        self.frontend = frontend
        self.num_processes = num_processes
        self.process_id = process_id
        self.mesh = mesh
        self.decode_window = max(1, decode_window)
        self.max_intake = max_intake
        # default: the full cache width, so anything the POST validation
        # accepted (prompt + max_new <= max_seq) fits the wire format
        self.max_prompt = (min(max_prompt, engine.cfg.max_seq - 1)
                           if max_prompt is not None
                           else engine.cfg.max_seq - 1)
        self._idle_sleep_s = idle_sleep_s
        self._stop = False
        self.iterations = 0
        self.errors = 0
        # rank 0 only: drained but unadmitted pendings (a paged engine
        # admits a FIFO prefix under page pressure), broadcast FIRST next
        # iteration; every rank re-submits the same prefix
        self._backlog: List[_Pending] = []
        if frontend is not None:
            # the front door's /v1/stats carries the loop's counters
            frontend.stats_extra = self._counters

    # ------------------------------------------------------------- loop

    def _broadcast(self, arr: np.ndarray) -> np.ndarray:
        if self.num_processes <= 1:
            return arr
        return self.mesh.broadcast_array(arr, src=0)

    def run_iteration(self) -> bool:
        """One lock-step iteration; True if any work happened."""
        fe = self.frontend
        pendings: List[_Pending] = []
        if fe is not None:
            # stamp BEFORE the work: a first-request prefill lives inside
            # this iteration and must not flap health
            fe.mark_driven()
            pendings.extend(self._backlog)
            self._backlog = []
            budget = (min(self.max_intake, len(self.engine.free_slots()))
                      - len(pendings))
            for p in fe.drain_intake(max(0, budget)):
                if len(p.prompt) > self.max_prompt:
                    # unreachable with the default (full cache width); a
                    # narrowed wire format fails loudly
                    p.finish(f"prompt exceeds gang max_prompt "
                             f"{self.max_prompt}")
                    continue
                pendings.append(p)
            arr = encode_intake([(p.prompt, p.max_new) for p in pendings],
                                self.max_intake, self.max_prompt)
        else:
            arr = np.zeros((self.max_intake, 2 + self.max_prompt),
                           np.int32)
        arr = self._broadcast(arr)
        items = decode_intake(arr)
        if items:
            now = time.perf_counter()
            subs = []
            for j, (prompt, max_new) in enumerate(items):
                rid = pendings[j] if fe is not None else object()
                if fe is not None:
                    pendings[j].t_submit = now
                subs.append({"prompt": prompt, "max_new": max_new,
                             "request_id": rid})
            # ONE batched admission on every rank: the same items in the
            # same order, so the same slots; both engines admit a FIFO
            # prefix, so pendings[len(placed):] is the unadmitted tail
            placed = self.engine.submit_many(subs)
            if fe is not None:
                for slot, rid in placed:
                    fe.attach(slot, rid)         # incl. instant retire
                self._backlog = pendings[len(placed):]
        worked = bool(items)
        if self.engine.requests_active():
            self.engine.step_many(self.decode_window)
            if fe is not None:
                fe.sync()
            worked = True
        if fe is None:
            # peers have no front door popping finished streams: without
            # this every retired request leaks on every rank but 0
            self.engine.finished.clear()
        self.iterations += 1
        return worked

    def _counters(self) -> dict:
        return {"gang_iterations": self.iterations,
                "gang_errors": self.errors,
                "process_id": self.process_id,
                "backlog": len(self._backlog)}

    def stats(self) -> dict:
        """Heartbeat payload: the loop's counters, the engine's paged
        counters when it has them, rank 0's front-door counters. Lock-step
        makes the engine's numbers the same on every rank, except
        ``gang_errors``, the per-member divergence canary."""
        out = self._counters()
        page_stats = getattr(self.engine, "page_stats", None)
        if callable(page_stats):
            out["pages"] = page_stats()
        if self.frontend is not None:
            out.update(self.frontend.stats())
        return out

    def run(self, max_iterations: Optional[int] = None,
            heartbeat_s: float = 0.0, on_heartbeat=None) -> None:
        """Drive until stopped (or ``max_iterations``, for tests).
        ``on_heartbeat(stats)`` fires every ``heartbeat_s`` on every
        rank with :meth:`stats`."""
        last_beat = time.monotonic()
        while not self._stop:
            if max_iterations is not None \
                    and self.iterations >= max_iterations:
                return
            try:
                worked = self.run_iteration()
            except RingPrefillError:
                raise                # the ranks may disagree: fail loudly
            except Exception as e:   # keep serving: a failed collective
                # surfaces on EVERY rank, so each fails its in-flight
                # work, resets its engine to the empty pool, and meets
                # the others again at the next broadcast
                self.errors += 1
                if self.frontend is not None:
                    self.frontend.fail_inflight(f"engine error: {e}")
                else:
                    self.engine.reset()
                worked = False
            if not worked:
                # the broadcast is the rendezvous; idle ranks sleep the
                # same nominal interval and meet again
                time.sleep(self._idle_sleep_s)
            if heartbeat_s and on_heartbeat is not None \
                    and time.monotonic() - last_beat >= heartbeat_s:
                last_beat = time.monotonic()
                on_heartbeat(self.stats())

    def stop(self) -> None:
        self._stop = True
        for p in self._backlog:
            p.finish("server stopped")
        self._backlog = []
