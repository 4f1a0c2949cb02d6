"""The port's slot engine (``dcos_commons_tpu_torch/models/serving.py:
SlotServer``) against the JAX ``SlotServer``, mirroring
``tests/test_serving.py``: per-slot decode equals solo decode row by row,
``drain()`` streams are token-exact with the reference in fp32 (slot
reuse, padded buckets, batched admission, windows with mid-window
retirement, EOS, a window that runs past ``max_seq``, int8 KV and int8
weights), sampling is deterministic under one generator seed, and bad
requests are refused. The fp32 tiny model makes the comparison one of
the algorithm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.ops.sampling import make_sampler

_MODELS = {}


def _model(kv_quant=False, int8_weights=False):
    """(JAX cfg, port cfg, JAX params, port params): the tiny 2-layer fp32
    engine model of the JAX serving tests, weights from ``key(0)``."""
    key = (kv_quant, int8_weights)
    if key not in _MODELS:
        kw = dict(n_layers=2, max_seq=64, kv_quant=kv_quant)
        jcfg = jl.LlamaConfig.tiny(attn_impl="dense", dtype=jnp.float32,
                                   **kw)
        tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
        jp = jl.init_params(jcfg, jax.random.key(0))
        if int8_weights:
            jp = jl.quantize_params(jp)
        _MODELS[key] = (jcfg, tcfg, jp,
                        params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[key]


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _reqs(seed, shape):
    return [{"prompt": _prompt(seed + i, n), "max_new": m, "request_id": i}
            for i, (n, m) in enumerate(shape)]


def _both(reqs, slots, window=1, kv_quant=False, int8_weights=False, **kw):
    """Drain ``reqs`` through both engines; returns (jax, port)."""
    jcfg, tcfg, jp, tp = _model(kv_quant, int8_weights)
    want = js.SlotServer(jcfg, jp, slots=slots, **kw).drain(
        [dict(r) for r in reqs], decode_window=window)
    got = ts.SlotServer(tcfg, tp, slots=slots, device="cpu", **kw).drain(
        [dict(r) for r in reqs], decode_window=window)
    return want, got


def _solo(tcfg, tp, prompt, steps):
    toks = tl.generate_chunked(tcfg, tp, torch.tensor([prompt]), steps,
                               chunk=4)
    return [int(t) for t in toks[0]]


def test_decode_step_slots_matches_decode_step_rows():
    """Two slots at different lengths decode each row as a solo
    ``decode_step`` at that row's position (the port alone), and the
    merged step matches the JAX merged step."""
    jcfg, tcfg, jp, tp = _model()
    pa, pb = _prompt(1, 8), _prompt(2, 16)
    caches, firsts = [], []
    for p in (pa, pb):
        c = tl.init_kv_cache(tcfg, 1, tcfg.max_seq, device="cpu")
        logits, c = tl.prefill(tcfg, tp, c, torch.tensor([p]))
        caches.append(c)
        firsts.append(torch.argmax(logits, -1).to(torch.int32))
    merged = {s: torch.cat([caches[0][s], caches[1][s]], dim=1)
              for s in ("k", "v")}
    lengths = torch.tensor([8, 16], dtype=torch.int32)
    tokens = torch.cat(firsts)
    logits, merged = tl.decode_step_slots(tcfg, tp, merged, lengths, tokens)
    for row, (pos, c) in enumerate(zip((8, 16), caches)):
        solo, c = tl.decode_step(tcfg, tp, c, pos, firsts[row])
        np.testing.assert_allclose(logits[row].numpy(), solo[0].numpy(),
                                   rtol=1e-4, atol=1e-4)
        # a [2, D] and a [1, D] fp32 matmul may sum in other orders
        np.testing.assert_allclose(merged["k"][:, row, pos].numpy(),
                                   c["k"][:, 0, pos].numpy(), atol=1e-5)
    jm = {s: jnp.zeros((2, 2, 64, 4, 8), jnp.float32) for s in ("k", "v")}
    for row, p in enumerate((pa, pb)):
        jc = jl.init_kv_cache(jcfg, 1, 64)
        _, jc = jl.prefill(jcfg, jp, jc, jnp.asarray([p], jnp.int32))
        jm = {s: jm[s].at[:, row].set(jc[s][:, 0]) for s in ("k", "v")}
    jlog, _ = jl.decode_step_slots(jcfg, jp, jm, jnp.asarray([8, 16]),
                                   jnp.asarray(tokens.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)


def test_streams_match_jax_and_solo_decode():
    """Three requests through two slots (slot reuse; 5 tokens pad to a
    bucket of 8) emit the JAX engine's streams, which are each request's
    solo greedy stream."""
    reqs = _reqs(10, [(8, 6), (5, 9), (12, 4)])
    want, got = _both(reqs, slots=2)
    assert got == want
    _, tcfg, _, tp = _model()
    for r in reqs:
        assert got[r["request_id"]] == _solo(tcfg, tp, r["prompt"],
                                             r["max_new"])


@pytest.mark.parametrize("kv_quant,int8_weights", [(True, False),
                                                   (True, True)])
def test_int8_kv_and_weights_match_jax(kv_quant, int8_weights):
    reqs = _reqs(20, [(8, 5), (16, 7), (4, 3)])
    want, got = _both(reqs, slots=2, window=3, kv_quant=kv_quant,
                      int8_weights=int8_weights)
    assert got == want


def test_eos_retires_like_jax():
    jcfg, tcfg, jp, tp = _model()
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    eos = _solo(tcfg, tp, prompt, 4)[1]
    reqs = [{"prompt": prompt, "max_new": 10, "request_id": "e"},
            {"prompt": _prompt(30, 6), "max_new": 10, "request_id": "f"}]
    want, got = _both(reqs, slots=2, window=4, eos_id=eos)
    assert got == want
    assert got["e"][-1] == eos and len(got["e"]) == 2


def test_sampling_is_deterministic_under_one_generator_seed():
    _, tcfg, _, tp = _model()
    prompt = _prompt(40, 8)
    sampler = make_sampler(temperature=1.0, top_k=8)
    runs = []
    for seed in (9, 9, 10):
        srv = ts.SlotServer(tcfg, tp, slots=1, sampler=sampler,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")
        runs.append(srv.drain([{"prompt": prompt, "max_new": 12,
                                "request_id": "s"}])["s"])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < tcfg.vocab_size for t in runs[0])


def test_rejects_empty_and_oversized():
    _, tcfg, _, tp = _model()
    srv = ts.SlotServer(tcfg, tp, slots=1, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], max_new=4)
    with pytest.raises(ValueError, match="max_seq"):
        srv.submit(list(range(8)), max_new=tcfg.max_seq)
    bad = []
    placed = srv.submit_many(
        [{"prompt": [], "request_id": "bad"},
         {"prompt": [1] * 60, "max_new": 10, "request_id": "long"},
         {"prompt": _prompt(41, 5), "max_new": 3, "request_id": "ok"}],
        on_invalid=lambda item, reason: bad.append(item["request_id"]))
    assert bad == ["bad", "long"] and placed == [(0, "ok")]
    assert srv.submit(_prompt(42, 4)) is None         # every slot taken
    with pytest.raises(ValueError, match="empty"):
        srv.submit_many([{"prompt": []}])


def test_submit_many_batches_admissions_like_jax():
    """Four free slots take four of five requests in power-of-two
    batches; streams equal the reference's."""
    jcfg, tcfg, jp, tp = _model()
    reqs = _reqs(70, [(8, 5), (5, 6), (12, 4), (6, 7), (9, 3)])
    srv = ts.SlotServer(tcfg, tp, slots=4, device="cpu")
    placed = srv.submit_many([dict(r) for r in reqs])
    assert [s for s, _ in placed] == [0, 1, 2, 3]
    assert [rid for _, rid in placed] == [0, 1, 2, 3]
    got = srv.drain([dict(r) for r in reqs[4:]])
    want = js.SlotServer(jcfg, jp, slots=4).drain([dict(r) for r in reqs])
    assert got == want


def test_step_many_equals_k_steps_through_mid_window_retirement():
    """Budgets that are not multiples of the window retire mid-window:
    the windowed streams equal the per-step ones and the JAX windowed
    engine's."""
    reqs = _reqs(80, [(8, 5), (5, 11), (12, 3), (6, 7)])
    _, tcfg, _, tp = _model()
    base = ts.SlotServer(tcfg, tp, slots=2, device="cpu").drain(
        [dict(r) for r in reqs])
    want, got = _both(reqs, slots=2, window=4)
    assert got == base == want


def test_window_past_max_seq_matches_jax():
    """A slot retiring at max_seq inside an 8-step window stays frozen
    with its length past the cache: its writes are dropped, the other
    slot's stream is untouched."""
    reqs = [{"prompt": _prompt(95, 58), "max_new": 6, "request_id": "long"},
            {"prompt": _prompt(96, 5), "max_new": 20, "request_id": "short"}]
    want, got = _both(reqs, slots=2, window=8)
    assert got == want
    assert len(got["long"]) == 6


def test_abort_reset_and_instant_retire():
    _, tcfg, _, tp = _model()
    srv = ts.SlotServer(tcfg, tp, slots=2, device="cpu")
    srv.submit(_prompt(50, 7), max_new=1, request_id="one")
    assert srv.step() == {}                 # the first token retired it
    assert srv.finished["one"] and srv.free_slots() == [0, 1]
    srv.submit(_prompt(51, 7), max_new=5, request_id="x")
    srv.submit(_prompt(52, 9), max_new=5, request_id="y")
    srv.step()
    assert srv.abort_active() == 2 and not srv.requests_active()
    srv.reset()
    assert srv.finished == {} and srv.free_slots() == [0, 1]
    assert int(srv.lengths.abs().sum()) == 0


def _cuda_rank():
    """Rank 0 of a tp=2 process mesh on a CUDA device (no process
    group: the engine refuses it before any collective)."""
    from dcos_commons_tpu_torch.parallel.mesh import Mesh
    return Mesh({"dp": 1, "pp": 1, "sp": 1, "tp": 2, "ep": 1},
                {"dp": 0, "pp": 0, "sp": 0, "tp": 0, "ep": 0},
                torch.device("cuda"), "nccl", rank=0)


@pytest.mark.parametrize("kw", [dict(mesh=_cuda_rank()),
                                dict(key=object())])
def test_constructor_refuses_features_not_ported(kw):
    """``key`` is no parameter (TypeError); ``mesh`` is ported
    (``tests/test_torch_tp.py``), and refused on another device type than
    the engine's (ValueError)."""
    _, tcfg, _, tp = _model()
    with pytest.raises(ValueError if "mesh" in kw else TypeError):
        ts.SlotServer(tcfg, tp, device="cpu", **kw)


def test_constructor_checks_the_device():
    _, tcfg, _, tp = _model()
    with pytest.raises(ValueError, match="params live on"):
        ts.SlotServer(tcfg, tp, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.SlotServer(tcfg, tp)
