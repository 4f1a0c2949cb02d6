"""MoE serving through the port's worker (``llama --serve --pages -1
--moe-experts E``, the command of ``frameworks/jax/dist/moe.yml``):
served as a subprocess on the CPU it answers ``POST /v1/generate`` with
the tokens of a port ``PagedServer(moe=...)`` built directly from the
same seed; the serving-arithmetic resolution (``moe_fallback`` with
``moe_needs_paged`` / ``moe_quant``, ``longctx_fallback`` with
``longctx_with_moe``, the capacity factor and the routing) emits the
reference worker's events and gives its MoE config; an MoE model that
the paged engine refuses does not fall back to the slot engine."""

import json
import signal

import pytest
import torch

import tests._jax_cpu  # noqa: F401

from frameworks.jax import worker as jworker
from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless
from tests.test_torch_worker import PROMPTS, _post, _Worker


def test_moe_worker_serves_the_engines_tokens(tmp_path):
    w = _Worker(tmp_path, "--serve", "--slots", "2", "--serve-port", "0",
                "--pages", "-1", "--moe-experts", "4")
    try:
        loaded = w.event("weights_loaded")
        assert loaded["source"] == "init"
        serving = w.event("serving")
        assert serving["paged"]["moe"] == {
            "experts": 4, "capacity_factor": 4.0, "routing": "top2"}
        assert serving["tokens_per_sec"] > 0
        got = [_post(serving["port"], {"prompt": p, "max_new": 6})["tokens"]
               for p in PROMPTS]
        hb = w.event("heartbeat", where=lambda e: e.get("requests") == 2)
        assert hb["paged"]["moe"]["experts"] == 4
        rc = w.stop()
    finally:
        if w.proc.poll() is None:
            w.proc.kill()
    assert rc == -signal.SIGTERM
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_moe_params(cfg, 4, torch.Generator().manual_seed(0),
                                device="cpu")
    srv = ts.PagedServer(cfg, params, slots=2, moe=dropless(MoEConfig(4)),
                         device="cpu")
    want = [srv.drain([{"prompt": p, "max_new": 6, "request_id": i}],
                      decode_window=8)[i] for i, p in enumerate(PROMPTS)]
    assert got == want


SERVE = ["llama", "--serve", "--slots", "2"]
ARITHMETIC = [
    ["--moe-experts", "4"],
    ["--moe-experts", "4", "--pages", "-1", "--quant", "int8"],
    ["--moe-experts", "4", "--pages", "-1", "--kv-quant"],
    ["--moe-experts", "4", "--pages", "-1", "--prefill-seq-parallel",
     "true"],
    ["--moe-experts", "8", "--pages", "64", "--moe-capacity-factor", "0"],
    ["--moe-experts", "8", "--pages", "64", "--moe-capacity-factor", "1.5",
     "--moe-routing", "expert_choice"],
    ["--moe-experts", "2", "--pages", "-1", "--moe-capacity-factor", "-1"],
    ["--pages", "-1"],
]


def _outcome(capsys, moe_cfg):
    events = [json.loads(line) for line in
              capsys.readouterr().out.splitlines() if line.startswith("{")]
    cfg = (None if moe_cfg is None else
           (moe_cfg.num_experts, moe_cfg.capacity_factor, moe_cfg.routing))
    return [(e["event"], e.get("code")) for e in events], cfg


@pytest.mark.parametrize("argv", ARITHMETIC,
                         ids=lambda a: "_".join(x.strip("-") for x in a))
def test_serving_arithmetic_matches_the_reference(argv, capsys):
    """The same flags give the reference's coded events and MoE config
    (the reference on one device: ``MeshSpec(ep=1)``, the local path)."""
    targs = tworker.build_parser().parse_args([*SERVE, *argv])
    got = _outcome(capsys, tworker._serving_arithmetic(targs))
    jargs = jworker.build_parser().parse_args([*SERVE, *argv])
    jcfg, ring, _ = jworker._serving_arithmetic(
        jargs, jl.LlamaConfig.tiny(), 1)
    want = _outcome(capsys, jcfg)
    assert got == want and ring == 0
    if "--moe-experts" in argv:
        assert got[1] is not None or got[0][0][0] == "moe_fallback"


def test_ring_prefill_without_moe_stays_refused():
    targs = tworker.build_parser().parse_args(
        [*SERVE, "--pages", "-1", "--prefill-seq-parallel", "true"])
    with pytest.raises(tworker.NotPorted) as ei:
        tworker._serving_arithmetic(targs)
    assert ei.value.code == "longctx_not_ported"


def test_moe_model_refused_by_the_paged_engine_does_not_serve_slots(capsys):
    """A paged config the model cannot satisfy emits ``paged_fallback``;
    with an MoE model it then raises, since the slot engine has no
    routed FFN."""
    args = tworker.build_parser().parse_args(
        [*SERVE, "--pages", "-1", "--page-size", "48", "--moe-experts", "4"])
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_moe_params(cfg, 4, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tworker._make_serving_engine(args, cfg, params, "cpu",
                                     moe=dropless(MoEConfig(4)))
    events = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["event"] for e in events] == ["paged_fallback"]
