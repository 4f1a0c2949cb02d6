"""``llama-train`` of the port's worker (``--device cpu``) against
``frameworks/jax/worker.py`` run in process: the result has the
reference's keys, a fresh ``--steps 3`` saves both optimizer counts at 4
in both packages (the warm-up's update is kept), and each package
resumes the other's checkpoint at its step with the counts going on."""

import json
import shutil

import numpy as np
import pytest

import tests._jax_cpu  # noqa: F401

from frameworks.jax import worker as jworker
from dcos_commons_tpu_torch.frameworks import worker as tworker
from tests.test_torch_worker_train import CPU, TRAIN, _counts, _done, _events


@pytest.fixture(scope="module")
def ref_fresh(tmp_path_factory):
    """The reference worker's fresh ``llama-train --steps 3``: its done
    event and its checkpoint directory (run once, in process)."""
    out = tmp_path_factory.mktemp("ref") / "vol"
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jworker.main([*TRAIN, "--steps", "3", "--out", str(out)]) == 0
    events = [json.loads(line) for line in buf.getvalue().splitlines()
              if line.startswith("{")]
    return _done(events), out


def test_fresh_run_has_the_reference_keys_and_counts_4(tmp_path, capsys,
                                                        ref_fresh):
    want, ref_out = ref_fresh
    out = tmp_path / "vol"
    assert tworker.main([*TRAIN, *CPU, "--steps", "3", "--out",
                         str(out)]) == 0
    got = _done(_events(capsys))
    assert sorted(got) == sorted(want)
    assert got["steps_run"] == 3 and np.isfinite(got["final_loss"])
    assert got["attn"] == "auto" and got["mesh"] == {"dp": 1, "sp": 1,
                                                     "tp": 1}
    assert got["fused_ce"] is True and got["grad_accum"] == 1
    assert _counts(out, 3) == _counts(ref_out, 3) == (4, 4)


def test_the_port_resumes_the_reference_s_checkpoint(tmp_path, capsys,
                                                     ref_fresh):
    _, ref_out = ref_fresh
    out = tmp_path / "vol"
    shutil.copytree(ref_out, out)
    assert tworker.main([*TRAIN, *CPU, "--steps", "5", "--out",
                         str(out)]) == 0
    events = _events(capsys)
    resumed = [e for e in events if e.get("event") == "resumed"]
    assert len(resumed) == 1 and resumed[0]["step"] == 3
    assert _done(events)["steps_run"] == 2
    assert _counts(out, 5) == (6, 6)


def test_the_reference_resumes_the_port_s_checkpoint(tmp_path, capsys):
    out = tmp_path / "vol"
    assert tworker.main([*TRAIN, *CPU, "--steps", "3", "--out",
                         str(out)]) == 0
    capsys.readouterr()
    assert jworker.main([*TRAIN, "--steps", "4", "--out", str(out)]) == 0
    events = _events(capsys)
    assert [e["step"] for e in events if e.get("event") == "resumed"] == [3]
    assert _done(events)["steps_run"] == 1
    assert _counts(out, 4) == (5, 5)
