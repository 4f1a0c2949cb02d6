"""The port's worker fault sentinel (``dcos_commons_tpu_torch/frameworks/
sentinel.py``, a copy of ``frameworks/jax/sentinel.py``): every case of
``tests/test_sentinel.py`` run on the copy (preemption flush, non-finite-
loss rollback, stall watchdog, the SIGTERM'd child exiting 143), and the
copy's code equal to the reference's statement for statement."""

import ast
import os
import signal
import threading
import time

import pytest

from dcos_commons_tpu_torch.frameworks.sentinel import (
    STALL_EXIT_CODE, FaultSentinel, guarded_loop)


def _loop(sentinel, script, start=0, steps=10, emit=None):
    """Drive guarded_loop over a scripted loss sequence. ``script`` maps
    step -> loss; checkpoints are recorded as (step, state-at-save)."""
    state = {"step": start}
    saves = []
    events = []

    def run_step(i):
        state["step"] = i + 1
        return script.get(i, 0.1)

    def save(i):
        saves.append(i)

    def restore():
        if not saves:
            return None
        state["step"] = saves[-1]
        return saves[-1]

    reason, nxt = guarded_loop(
        sentinel, start, steps, run_step, loss_of=lambda r: r,
        save=save, restore=restore,
        emit=(emit if emit is not None else events.append))
    return reason, nxt, state, saves, events


def test_completed_run():
    reason, nxt, state, saves, events = _loop(FaultSentinel(), {})
    assert (reason, nxt) == ("completed", 10)
    assert state["step"] == 10
    assert not events


def test_preemption_flushes_checkpoint_and_returns_resume_step():
    sent = FaultSentinel()
    script = {}
    seen = []

    def run_step(i):
        seen.append(i)
        if i == 3:
            sent.preempted = True  # SIGTERM lands mid-run
        return 0.1

    saves = []
    events = []
    reason, nxt = guarded_loop(sent, 0, 10, run_step, lambda r: r,
                               saves.append, lambda: None,
                               emit=events.append)
    assert reason == "preempted"
    assert nxt == 4          # step 3 completed; resume at 4
    assert saves == [4]      # checkpoint flushed before exiting
    assert seen == [0, 1, 2, 3]
    assert any(e["event"] == "preempted" for e in events)


def test_sigterm_handler_flips_flag():
    sent = FaultSentinel()
    sent.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        # the handler runs synchronously on the main thread's next bytecode
        for _ in range(100):
            if sent.preempted:
                break
            time.sleep(0.01)
        assert sent.preempted
    finally:
        sent.uninstall()


def test_nan_rolls_back_to_last_checkpoint():
    sent = FaultSentinel(max_rollbacks=3)
    first_visit = {"nan": True}

    def script_loss(i):
        if i == 5 and first_visit["nan"]:
            first_visit["nan"] = False  # transient: clean on the re-run
            return float("nan")
        return 0.1

    saves = [3]  # pretend a periodic save landed at step 3
    state = {"step": 0}
    events = []

    def run_step(i):
        state["step"] = i + 1
        return script_loss(i)

    def restore():
        state["step"] = saves[-1]
        return saves[-1]

    reason, nxt = guarded_loop(sent, 0, 8, run_step, lambda r: r,
                               saves.append, restore, emit=events.append)
    assert (reason, nxt) == ("completed", 8)
    # steps 3 and 4 re-ran after the rollback — LR/step resume semantics:
    # restore() hands back the checkpoint step and the loop continues there
    assert [e["event"] for e in events] == ["nonfinite_loss", "rolled_back"]
    assert events[1]["to_step"] == 3


def test_deterministic_nan_gives_up_after_max_rollbacks():
    sent = FaultSentinel(max_rollbacks=2)
    saves = [0]
    calls = {"restores": 0}

    def restore():
        calls["restores"] += 1
        return 0

    with pytest.raises(RuntimeError, match="crash-loop"):
        guarded_loop(sent, 0, 5,
                     lambda i: float("inf") if i == 2 else 0.1,
                     lambda r: r, saves.append, restore)
    assert calls["restores"] == 2  # rolled back max_rollbacks times


def test_nan_with_no_checkpoint_raises():
    sent = FaultSentinel()
    with pytest.raises(RuntimeError, match="no checkpoint"):
        guarded_loop(sent, 0, 3, lambda i: float("nan"), lambda r: r,
                     lambda i: None, lambda: None)


def test_nan_every_skips_unchecked_steps():
    sent = FaultSentinel(nan_every=4)
    checked = []

    def loss_of(r):
        checked.append(r)
        return 0.1

    guarded_loop(sent, 0, 10, lambda i: i, loss_of,
                 lambda i: None, lambda: None)
    assert checked == [0, 4, 8]
    assert not FaultSentinel(nan_every=0).should_check_loss(0)


def test_stall_watchdog_fires_injected_abort():
    fired = threading.Event()
    aborted = []

    def abort(step, stall_s):
        aborted.append((step, stall_s))
        fired.set()

    events = []
    sent = FaultSentinel(stall_s=0.05, emit=events.append, abort=abort)
    with sent.watch(7):
        assert fired.wait(timeout=5.0), "watchdog never fired"
    assert aborted == [(7, 0.05)]
    assert events[0]["event"] == "stall"
    assert events[0]["step"] == 7


def test_stall_watchdog_disarms_on_fast_step():
    aborted = []
    sent = FaultSentinel(stall_s=5.0, abort=lambda s, t: aborted.append(s))
    with sent.watch(0):
        pass  # completes immediately
    time.sleep(0.05)
    assert not aborted


def test_stall_default_abort_is_hard_exit_code():
    assert STALL_EXIT_CODE == 74  # documented contract with the scheduler


def test_from_env_reads_knobs():
    env = {"SENTINEL_STALL_S": "120", "SENTINEL_NAN_EVERY": "8",
           "SENTINEL_MAX_ROLLBACKS": "1"}
    sent = FaultSentinel.from_env(env=env)
    assert (sent.stall_s, sent.nan_every, sent.max_rollbacks) == (120.0, 8, 1)
    defaults = FaultSentinel.from_env(env={})
    assert (defaults.stall_s, defaults.nan_every,
            defaults.max_rollbacks) == (0.0, 1, 3)
    off = FaultSentinel.from_env(env={"SENTINEL_NAN_EVERY": "0"})
    assert not off.should_check_loss(0)


def test_watch_noop_when_stall_disabled():
    sent = FaultSentinel(stall_s=0.0, abort=lambda s, t: pytest.fail("armed"))
    with sent.watch(0):
        time.sleep(0.01)


# -- preemption flush under a real SIGTERM (elastic flush-grace contract) --

def test_sigterm_mid_step_flushes_once_and_stops():
    """SIGTERM delivered while a step (with its periodic checkpoint write)
    is in flight: the in-progress work finishes, the loop flushes exactly
    one checkpoint at the next boundary, and no further step runs."""
    sent = FaultSentinel()
    sent.install()
    saves = []
    seen = []
    try:
        def run_step(i):
            seen.append(i)
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
                for _ in range(500):     # handler runs on a next bytecode
                    if sent.preempted:
                        break
                    time.sleep(0.01)
                assert sent.preempted
            return 0.1

        reason, nxt = guarded_loop(sent, 0, 10, run_step, lambda r: r,
                                   saves.append, lambda: None)
    finally:
        sent.uninstall()
    assert (reason, nxt) == ("preempted", 4)
    assert saves == [4]              # exactly one flush, no double-save
    assert seen == [0, 1, 2, 3]      # nothing runs after the signal


_PREEMPT_CHILD = r'''
import sys, time
from dcos_commons_tpu_torch.frameworks.sentinel import (
    FaultSentinel, guarded_loop)

sent = FaultSentinel()
sent.install()
flushes = []

def run_step(i):
    if i == 1:
        print("CKPT_BEGIN", flush=True)
        time.sleep(3.0)              # checkpoint write in progress
        print("CKPT_END", flush=True)
    else:
        time.sleep(0.02)
    return 0.1

def save(i):
    flushes.append(i)
    print("FLUSH %d" % i, flush=True)

reason, _ = guarded_loop(sent, 0, 10_000, run_step, lambda r: r,
                         save, lambda: None)
assert reason == "preempted", reason
assert len(flushes) == 1, flushes
sys.exit(143)                        # the worker-main SIGTERM convention
'''


def test_sigterm_mid_checkpoint_exits_143_within_grace():
    """End-to-end flush-grace contract (the scheduler side of this is
    Preemptor.grace_ticks): a worker-shaped child SIGTERM'd in the middle
    of a checkpoint write lets the write finish, flushes once, and exits
    143 well inside the grace window — never a second checkpoint, never
    an unclean exit code."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.Popen(
        [sys.executable, "-c", _PREEMPT_CHILD],
        cwd=Path(__file__).resolve().parent.parent,
        stdout=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("CKPT_BEGIN"):
                proc.send_signal(signal.SIGTERM)   # mid-checkpoint
                break
        lines += [l.strip() for l in proc.stdout]  # drain to EOF
        rc = proc.wait(timeout=30)                 # the "grace window"
    finally:
        proc.kill()
    assert rc == 143, (rc, lines)
    flushes = [l for l in lines if l.startswith("FLUSH")]
    assert flushes == ["FLUSH 2"], lines
    # the interrupted checkpoint completed before the flush
    assert lines.index("CKPT_END") < lines.index("FLUSH 2")


def test_the_copy_is_the_reference_statement_for_statement():
    """Behaviour unchanged: apart from the module docstring, the port's
    sentinel parses to the same syntax tree as the reference's."""
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent

    def body(rel):
        tree = ast.parse((root / rel).read_text())
        return [ast.dump(node) for node in tree.body[1:]]

    assert body("dcos_commons_tpu_torch/frameworks/sentinel.py") == body(
        "frameworks/jax/sentinel.py")
