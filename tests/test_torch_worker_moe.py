"""MoE serving through the port's worker (``llama --serve --pages -1
--moe-experts E``, the command of ``frameworks/jax/dist/moe.yml``):
served as a subprocess on the CPU it answers ``POST /v1/generate`` with
the tokens of a port ``PagedServer(moe=...)`` built directly from the
same seed; the serving-arithmetic resolution (``moe_fallback`` with
``moe_needs_paged`` / ``moe_quant``, ``longctx_fallback`` with
``longctx_with_moe``, the capacity factor and the routing) emits the
reference worker's events and gives its MoE config; so do the ring
prefill's (``longctx_needs_paged``, ``longctx_quant``,
``longctx_ring_devices``, ``longctx_ring_max_seq``, or the ring armed
over ``MeshSpec(sp=n)``), on one device and on gangs of 2 and 4; an MoE
model that the paged engine refuses does not fall back to the slot
engine."""

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
    ["--prefill-seq-parallel", "true"],
    ["--pages", "-1", "--kv-quant", "--prefill-seq-parallel", "true"],
    ["--pages", "-1", "--prefill-seq-parallel", "true"],
    ["--pages", "-1", "--prefill-seq-parallel", "true", "--longctx-ring",
     "2"],
    ["--pages", "-1", "--prefill-seq-parallel", "true", "--max-seq", "66"],
    ["--pages", "-1", "--prefill-seq-parallel", "false"],
]


def _outcome(capsys, moe_cfg):
    events = [json.loads(line) for line in
              capsys.readouterr().out.splitlines() if line.startswith("{")]
    cfg = (None if moe_cfg is None else
           (moe_cfg.num_experts, moe_cfg.capacity_factor, moe_cfg.routing))
    return [(e["event"], e.get("code")) for e in events], cfg


def _arithmetic(argv, n, capsys):
    """Port and reference ``_serving_arithmetic(args, cfg, n)`` on the same
    flags: each side's (events, MoE config), ring and mesh axes."""
    out = []
    for worker, cfg_of in ((tworker, tl.LlamaConfig.tiny),
                           (jworker, jl.LlamaConfig.tiny)):
        args = worker.build_parser().parse_args([*SERVE, *argv])
        cfg = cfg_of(max_seq=args.max_seq) if args.max_seq else cfg_of()
        moe_cfg, ring, spec = worker._serving_arithmetic(args, cfg, n)
        axes = (None if spec is None else
                {a: getattr(spec, a) for a in ("dp", "pp", "sp", "tp", "ep",
                                                "dcn")})
        out.append((_outcome(capsys, moe_cfg), ring, axes))
    return out


@pytest.mark.parametrize("argv", ARITHMETIC,
                         ids=lambda a: "_".join(x.strip("-") for x in a))
def test_serving_arithmetic_matches_the_reference(argv, capsys):
    """The same flags give the reference's coded events, MoE config, ring
    and mesh on one device (MoE: ``MeshSpec(ep=1)``, the local path; the
    ring: ``longctx_ring_devices``, chunks)."""
    got, want = _arithmetic(argv, 1, capsys)
    assert got == want and got[1] == 0
    if "--moe-experts" in argv:
        assert got[0][1] is not None or got[0][0][0][0] == "moe_fallback"


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("argv", ARITHMETIC,
                         ids=lambda a: "_".join(x.strip("-") for x in a))
def test_serving_arithmetic_on_a_gang_matches_the_reference(argv, n,
                                                            capsys):
    """On a gang of n (the reference: n devices) the same flags give the
    same events, ring and mesh: ``MeshSpec(sp=n)`` where the ring arms,
    ``MeshSpec(ep=n)`` (or ``ep=1`` with ``moe_note``) for MoE."""
    got, want = _arithmetic(argv, n, capsys)
    assert got == want
    if got[1]:
        assert got[1] == n and got[2]["sp"] == n


def test_ring_prefill_without_moe_is_armed_on_a_gang(capsys):
    """``--prefill-seq-parallel true`` with ``--pages``: ring prefill over
    ``MeshSpec(sp=n)`` on a gang of n, no event; on one device the
    reference's ``longctx_ring_devices`` and chunks."""
    targs = tworker.build_parser().parse_args(
        [*SERVE, "--pages", "-1", "--prefill-seq-parallel", "true"])
    cfg = tl.LlamaConfig.tiny()
    moe_cfg, ring, spec = tworker._serving_arithmetic(targs, cfg, 2)
    assert moe_cfg is None and ring == 2 and spec.sp == 2 and spec.tp == 1
    assert capsys.readouterr().out == ""
    assert tworker._serving_arithmetic(targs, cfg, 1) == (None, 0, None)
    events = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    assert [e["code"] for e in events] == ["longctx_ring_devices"]


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
