"""The port worker's ``llama-train --sp 1 --tp 2`` on a gang:
``launch_local`` starts the processes with the scheduler's ``JAX_*`` rank
contract, and each runs ``worker.main`` in turn
(``tests/_torch_dp_ranks.worker_runs``) with its own volume, as
``dist/longctx.yml``'s ``worker`` pods do.

* a gang of 2 at tp=2: both ranks report one loss stream and ``"mesh":
  {"dp": 1, "sp": 1, "tp": 2}``; a relaunch with more ``--steps``
  resumes both at one step and ends bitwise where a fresh run of as many
  steps ends; with rank 1's newest step removed, both resume at the step
  they share and end there again; each rank's step directory holds its
  Megatron shards, ``wq``'s moments as the reference's row shards;
* the tiny preset trains on the gang within 1e-3 of one process of the
  worker (bf16: the ranks' partial sums round in another order);
* a gang of 4 at dp=2 x tp=2 (``--tp 2`` on 4 processes): one loss
  stream on every rank, ``"mesh": {"dp": 2, "sp": 1, "tp": 2}``.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_dp_ranks

CPU = ["--device", "cpu"]
TP_TRAIN = ["llama-train", "--sp", "1", "--tp", "2", "--seq", "32", *CPU]


def _done(events):
    return [e for e in events if e["event"] == "done"][0]


def _of(events, name):
    return [e for e in events if e["event"] == name]


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tp_gang2"))
    runs = [("a", [*TP_TRAIN, "--steps", "2"], {}, []),
            ("a", [*TP_TRAIN, "--steps", "4"], {}, []),
            ("b", [*TP_TRAIN, "--steps", "4"], {}, []),
            ("a", [*TP_TRAIN, "--steps", "4"], {}, [1])]
    return base, launch_local(_torch_dp_ranks.worker_runs, 2, base, runs,
                              timeout_s=400, threads=1)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tp_gang4"))
    runs = [("c", [*TP_TRAIN, "--steps", "2"], {}, [])]
    return launch_local(_torch_dp_ranks.worker_runs, 4, base, runs,
                        timeout_s=400, threads=1)


def test_tp_gang_trains_one_loss_stream(gang2):
    _, ranks = gang2
    for run in range(4):
        dones = [_done(r[run][1]) for r in ranks]
        assert [r[run][0] for r in ranks] == [0, 0]
        assert [d["process_id"] for d in dones] == [0, 1]
        assert all(d["mesh"] == {"dp": 1, "sp": 1, "tp": 2} for d in dones)
        assert dones[0]["final_loss"] == dones[1]["final_loss"]
        assert np.isfinite(dones[0]["final_loss"])
        assert dones[0]["tp"] == 2 and dones[0]["backend"] == "gloo"


def test_tp_gang_resumes_every_rank_at_one_step_bitwise(gang2):
    """The relaunch resumes both ranks at 2 and ends where a fresh run
    to 4 ends, bit for bit; after rank 1 loses step 4, both resume at 2
    again and end there again."""
    _, ranks = gang2
    for r in ranks:
        assert _of(r[0][1], "resumed") == []
        for run in (1, 3):
            resumed = _of(r[run][1], "resumed")
            assert [e["step"] for e in resumed] == [2], run
            assert _done(r[run][1])["steps_run"] == 2
        fresh = _done(r[2][1])
        assert _of(r[2][1], "resumed") == [] and fresh["steps_run"] == 4
        assert _done(r[1][1])["final_loss"] == fresh["final_loss"]
        assert _done(r[3][1])["final_loss"] == fresh["final_loss"]
    for r, runs in enumerate(ranks):
        assert runs[3][2] == [f"step-0000000{k}-p{r}" for k in (2, 4)]


def test_tp_gang_checkpoint_holds_the_reference_shards(gang2):
    """Each rank's step 4 names its own Megatron shards under the whole
    leaves' shapes, and ``wq``'s moments as row shards (the reference's
    shape-keyed placement); the norms whole and the same bytes on both
    ranks."""
    base, _ = gang2
    man = [json.loads(open(f"{base}/a/r{r}/step-00000004-p{r}/"
                           "manifest.json").read())["leaves"]
           for r in (0, 1)]
    for r in (0, 1):
        wq = man[r]["params.layers.wq"]
        assert wq["global_shape"] == [4, 64, 64]
        assert [s["index"] for s in wq["shards"]] == [f"o0_0_{32 * r}"]
        for side in ("mu", "nu"):
            mom = man[r][f"opt_state.1.0.{side}.layers.wq"]
            assert [(s["index"], s["local_shape"]) for s in mom["shards"]] \
                == [(f"o0_{32 * r}_0", [4, 32, 64])]
            wk = man[r][f"opt_state.1.0.{side}.layers.wk"]
            assert [s["index"] for s in wk["shards"]] == [f"o0_0_{16 * r}"]
        emb = man[r]["params.embed"]
        assert [s["index"] for s in emb["shards"]] == [f"o{128 * r}_0"]
    for key in ("params.norm", "params.layers.attn_norm",
                "opt_state.1.0.nu.layers.ffn_norm", "opt_state.1.0.count"):
        assert man[0][key]["shards"] == man[1][key]["shards"], key


def test_tp_gang_tracks_one_process(gang2, tmp_path):
    _, ranks = gang2
    buf = io.StringIO()
    argv = ["llama-train", "--seq", "32", *CPU, "--steps", "4",
            "--out", str(tmp_path / "one")]
    with contextlib.redirect_stdout(buf):
        assert tworker.main(argv) == 0
    want = _done([json.loads(line) for line in buf.getvalue().splitlines()
                  if line.startswith("{")])
    assert want["mesh"] == {"dp": 1, "sp": 1, "tp": 1}
    got = _done(ranks[0][2][1])
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)


def test_dp_by_tp_gang_trains_one_loss_stream(gang4):
    dones = [_done(runs[0][1]) for runs in gang4]
    assert [runs[0][0] for runs in gang4] == [0] * 4
    assert all(d["mesh"] == {"dp": 2, "sp": 1, "tp": 2} for d in dones)
    assert len({d["final_loss"] for d in dones}) == 1
    assert np.isfinite(dones[0]["final_loss"])
