"""The port worker's ``mnist`` and ``resnet`` (``--device cpu``) against
``frameworks/jax/worker.py``: the same events and result keys, the
reference's checkpoint keys, shapes and dtypes, the optimizer counts
(``resnet`` keeps the warm-up's update: Adam count k + 1 at step k),
``--emit-every`` progress lines, ``final_loss`` null when nothing ran,
the mesh refusing more slices than processes, and checkpoints crossing between
the packages in both directions.

The reference's ``mnist`` runs in process. Its ``resnet`` shards the
batch over every JAX device, and the test process has eight virtual
ones, so it runs in process with ``jax.devices`` and ``jax.device_count``
showing it the first of them alone (one CPU device, as a subprocess
with one virtual device would give it, without a second interpreter
importing JAX), once: it resumes the port's checkpoint, and the port
then resumes the reference's.
"""

import contextlib
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import tests._jax_cpu  # noqa: F401

from frameworks.jax import worker as jworker
from dcos_commons_tpu_torch.frameworks import worker as tworker
from tests.test_torch_worker_train import CPU, _counts, _done, _events

RESNET = ["resnet", "--depth", "18", "--batch", "2"]
MNIST = ["mnist"]


def _manifest(out, step):
    return json.loads((Path(out) / f"step-{step:08d}-p0"
                       / "manifest.json").read_text())["leaves"]


def _same_layout(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k]["dtype"] == b[k]["dtype"], k
        assert a[k]["global_shape"] == b[k]["global_shape"], k


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """The port's fresh ``resnet --steps 2`` (checkpoints at 1 and 2), the
    reference resuming it to 3 with ``--emit-every 1`` (on one JAX
    device), then the port resuming the reference's step 3 to 4:
    ``(vol, port fresh events, reference events, port resumed events)``."""
    vol = tmp_path_factory.mktemp("resnet") / "vol"

    def run(main, *argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([*RESNET, *argv]) == 0
        return [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]

    fresh = run(tworker.main, *CPU, "--steps", "2", "--out", str(vol))
    counts_2 = _counts(vol, 2)
    real = jax.devices, jax.device_count
    try:
        jax.devices = lambda *a: real[0](*a)[:1]
        jax.device_count = lambda *a: 1
        ref = run(jworker.main, "--steps", "3", "--emit-every", "1",
                  "--out", str(vol))
    finally:
        jax.devices, jax.device_count = real
    ref_manifest = _manifest(vol, 3)
    counts_3 = _counts(vol, 3)
    resumed = run(tworker.main, *CPU, "--steps", "4", "--emit-every", "2",
                  "--out", str(vol))
    return {"vol": vol, "fresh": fresh, "ref": ref, "resumed": resumed,
            "counts": {2: counts_2, 3: counts_3, 4: _counts(vol, 4)},
            "ref_manifest": ref_manifest}


def test_resnet_events_and_result_keys_are_the_reference_s(crossed):
    fresh, ref = crossed["fresh"], crossed["ref"]
    assert [e["event"] for e in fresh] == ["start", "done"]
    assert [e["event"] for e in ref] == ["start", "resumed", "progress",
                                         "done"]
    got, want = _done(fresh), _done(ref)
    assert sorted(got) == sorted(want)
    assert got["workload"] == "resnet" and got["depth"] == 18
    assert got["steps"] == 2 and got["global_batch"] == 2
    assert np.isfinite(got["final_loss"])
    assert got["images_per_sec_per_chip"] > 0
    assert sorted(fresh[0]) == sorted(ref[0])


def test_resnet_checkpoints_carry_the_reference_keys_and_counts(crossed):
    """The port's step-2 checkpoint and the reference's step 3 hold the
    same leaves (params, optimizer state, batch-norm state) with the same
    shapes and dtypes; the warm-up's update is kept, so the Adam and
    schedule counts are k + 1 at step k in both."""
    _same_layout(_manifest(crossed["vol"], 4), crossed["ref_manifest"])
    assert any(k.startswith("state.stage3_block1.bn1.")
               for k in crossed["ref_manifest"])
    assert crossed["counts"] == {2: (3, 3), 3: (4, 4), 4: (5, 5)}


def test_resnet_resumes_cross_in_both_directions(crossed):
    ref, resumed = crossed["ref"], crossed["resumed"]
    assert [e["step"] for e in ref if e["event"] == "resumed"] == [2]
    assert _done(ref)["steps"] == 1
    assert [e for e in resumed if e["event"] == "resumed"] == [
        {"event": "resumed", "step": 3}]
    assert _done(resumed)["steps"] == 1


def test_emit_every_streams_progress_as_the_reference(crossed):
    progress = [e for e in crossed["ref"] if e["event"] == "progress"]
    assert [e["step"] for e in progress] == [3]
    ours = [e for e in crossed["resumed"] if e["event"] == "progress"]
    assert [e["step"] for e in ours] == [4]
    assert sorted(ours[0]) == sorted(progress[0])
    assert ours[0]["loss"] == _done(crossed["resumed"])["final_loss"]


def test_a_resnet_run_past_its_target_reports_null_loss(tmp_path, capsys):
    out = tmp_path / "vol"
    assert tworker.main([*RESNET, *CPU, "--steps", "1", "--out",
                         str(out)]) == 0
    capsys.readouterr()
    assert tworker.main([*RESNET, *CPU, "--steps", "1", "--out",
                         str(out)]) == 0
    done = _done(_events(capsys))
    assert done["steps"] == 0 and done["final_loss"] is None
    assert done["images_per_sec_per_chip"] == 0.0
    assert _counts(out, 1) == (2, 2)


def test_resnet_across_slices_is_refused(monkeypatch, capsys):
    """Across slices the dp axis spans ``MEGASCALE_NUM_SLICES`` slices of
    ``n // slices`` processes each; one process cannot hold 2 slices, and
    the mesh refuses it as the reference's mesh refuses too few devices
    (the gang cases are ``tests/test_torch_worker_dp.py``'s)."""
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    with pytest.raises(ValueError, match="needs 0 processes"):
        tworker.main([*RESNET, *CPU])
    assert [e["event"] for e in _events(capsys)] == ["start"]


def test_mnist_matches_the_reference_and_resumes_across(tmp_path, capsys):
    """A fresh ``mnist --steps 4`` of each package: the same events and
    result keys, params-only checkpoints at 1, 2, 3 and 4 (keep 3) with
    the reference's keys, shapes and dtypes; then each resumes the
    other's at step 4 (a fresh optimizer state) and runs 2 more."""
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert tworker.main([*MNIST, *CPU, "--steps", "4", "--out",
                         str(ours)]) == 0
    got = _events(capsys)
    assert jworker.main([*MNIST, "--steps", "4", "--out", str(ref)]) == 0
    want = _events(capsys)
    assert [e["event"] for e in got] == [e["event"] for e in want] == [
        "start", "done"]
    assert sorted(_done(got)) == sorted(_done(want))
    assert _done(got)["steps"] == 4 and np.isfinite(
        _done(got)["final_loss"])
    steps = sorted(int(p.name[5:13]) for p in ours.iterdir())
    assert steps == sorted(int(p.name[5:13]) for p in ref.iterdir()) == [
        2, 3, 4]
    _same_layout(_manifest(ours, 4), _manifest(ref, 4))
    assert sorted(_manifest(ours, 4)) == [
        f"params.layer{i}.{k}" for i in range(3) for k in ("b", "w")]
    assert tworker.main([*MNIST, *CPU, "--steps", "6", "--out",
                         str(ref)]) == 0
    assert [e["step"] for e in _events(capsys)
            if e["event"] == "resumed"] == [4]
    assert jworker.main([*MNIST, "--steps", "6", "--out", str(ours)]) == 0
    events = _events(capsys)
    assert [e["step"] for e in events if e["event"] == "resumed"] == [4]
    assert _done(events)["steps"] == 2
