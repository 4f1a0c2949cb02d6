"""The port's slot-cache model path (``dcos_commons_tpu_torch/models/
llama.py``) against the JAX reference on the same numpy inputs, with
parameters through ``params_from_jax`` and caches through
``cache_from_jax``: ``decode_step``, ``decode_step_slots``, ``prefill``,
``prefill_trunk``, ``decode_chunk_logits``, ``generate`` /
``generate_stepwise`` / ``generate_chunked`` and ``quantize_params``, in
fp32 and bf16, with bf16 and int8 KV and int8 weights. Two traps of the
reference are pinned: a solo write past the cache clamps onto its last
row, and a per-slot write at a length >= max_seq is dropped.

Tolerances: fp32 logits and caches within 1e-4 (two layers of fp32
matmuls summed in another order); bf16 logits and caches within 5e-2
(bf16 matmul outputs rounded at the same places in both, one-ulp flips
carried through two layers); int8 cache payloads within one quantization
step in fp32 (a value on a rounding boundary may round either way), and
in bf16 the dequantized values within 5e-2 plus one step. Greedy tokens
are compared exactly in fp32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu.ops import rope_frequencies as j_rope
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models.bridge import (cache_from_jax,
                                                  params_from_jax)
from dcos_commons_tpu_torch.ops.quant import QTensor
from dcos_commons_tpu_torch.ops.rotary import rope_frequencies as t_rope

MAX_SEQ = 64
_MODELS = {}


def _model(dtype="fp32", kv_quant=False, int8_weights=False):
    """(JAX cfg, port cfg, JAX params, port params) of the tiny 2-layer
    model, weights from ``key(0)``."""
    key = (dtype, kv_quant, int8_weights)
    if key not in _MODELS:
        jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        kw = dict(n_layers=2, max_seq=MAX_SEQ, kv_quant=kv_quant)
        jcfg = jl.LlamaConfig.tiny(attn_impl="dense", dtype=jdt, **kw)
        tcfg = tl.LlamaConfig.tiny(dtype=tdt, **kw)
        jp = jl.init_params(jcfg, jax.random.key(0))
        if int8_weights:
            jp = jl.quantize_params(jp)
        _MODELS[key] = (jcfg, tcfg, jp,
                        params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[key]


def _np(x):
    if isinstance(x, QTensor):
        return x.q.numpy(), x.s.float().numpy()
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    if isinstance(x, jquant.QTensor):
        return np.asarray(x.q), np.asarray(x.s, np.float32)
    return np.asarray(x, np.float32)


def _cache_close(tcache, jcache, tol):
    """int8 caches: in fp32 payloads within one step and scales within
    2e-2; in bf16, where K/V differ by the logits' tolerance before they
    quantize, the dequantized values within that plus one step."""
    for side in ("k", "v"):
        t, j = _np(tcache[side]), _np(jcache[side])
        if not isinstance(t, tuple):
            np.testing.assert_allclose(t, j, **tol)
        elif tol["rtol"]:
            assert np.abs(t[0].astype(int) - j[0].astype(int)).max() <= 1
            np.testing.assert_allclose(t[1], j[1], rtol=2e-2, atol=1e-6)
        else:
            step = np.maximum(t[1], j[1])
            assert np.all(np.abs(t[0] * t[1] - j[0] * j[1])
                          <= tol["atol"] + step)


def _tol(dtype):
    return (dict(rtol=1e-4, atol=1e-4) if dtype == "fp32"
            else dict(rtol=0, atol=5e-2))


def _random_cache(jcfg, batch, seed):
    """A JAX slot cache holding random K/V (what earlier steps wrote), and
    the port's copy of it."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, batch, MAX_SEQ, jcfg.n_kv_heads, jcfg.head_dim)
    sides = {s: jnp.asarray(rng.standard_normal(shape), jcfg.dtype)
             for s in ("k", "v")}
    if jcfg.kv_quant:
        sides = {s: jquant.quantize(x, axis=-1) for s, x in sides.items()}
    return sides, cache_from_jax(jax.device_get(sides), device="cpu")


def _prompt(seed, b, n, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


CASES = [("fp32", False, False), ("bf16", False, False),
         ("fp32", True, False), ("fp32", False, True), ("bf16", True, True)]
IDS = ["fp32", "bf16", "fp32-int8kv", "fp32-int8w", "bf16-int8kv-int8w"]


@pytest.mark.parametrize("dtype,kv_quant,int8_weights", CASES, ids=IDS)
def test_decode_step_slots_matches_jax(dtype, kv_quant, int8_weights):
    """Five slots: mid-cache, empty, the last row, and two frozen past
    max_seq whose writes the reference drops."""
    jcfg, tcfg, jp, tp = _model(dtype, kv_quant, int8_weights)
    jcache, tcache = _random_cache(jcfg, 5, 1)
    lengths = np.array([17, 0, MAX_SEQ - 1, MAX_SEQ, MAX_SEQ + 6], np.int32)
    tokens = np.array([5, 200, 31, 7, 99], np.int32)
    jlog, jcache2 = jl.decode_step_slots(jcfg, jp, jcache,
                                         jnp.asarray(lengths),
                                         jnp.asarray(tokens))
    before = _np(tcache["k"])
    tlog, tcache2 = tl.decode_step_slots(tcfg, tp, tcache,
                                         torch.from_numpy(lengths),
                                         torch.from_numpy(tokens))
    assert tcache2 is tcache                       # written in place
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (5, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol(dtype))
    _cache_close(tcache2, jcache2, _tol(dtype))
    after = _np(tcache2["k"])
    # the frozen rows wrote nothing: slots 3 and 4 are bit-for-bit as before
    for b, a in zip(before if isinstance(before, tuple) else (before,),
                    after if isinstance(after, tuple) else (after,)):
        np.testing.assert_array_equal(a[:, 3:], b[:, 3:])


@pytest.mark.parametrize("dtype,kv_quant,int8_weights", CASES, ids=IDS)
def test_decode_step_matches_jax(dtype, kv_quant, int8_weights):
    jcfg, tcfg, jp, tp = _model(dtype, kv_quant, int8_weights)
    jcache, tcache = _random_cache(jcfg, 3, 2)
    tokens = np.array([5, 200, 31], np.int32)
    jlog, jcache2 = jl.decode_step(jcfg, jp, jcache, jnp.int32(23),
                                   jnp.asarray(tokens))
    tlog, _ = tl.decode_step(tcfg, tp, tcache, 23, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol(dtype))
    _cache_close(tcache, jcache2, _tol(dtype))


@pytest.mark.parametrize("pos", [MAX_SEQ - 1, MAX_SEQ, MAX_SEQ + 9])
def test_decode_step_past_the_cache_clamps_like_jax(pos):
    """``dynamic_update_slice`` clamps a start past the end onto the last
    row; rope and the attention length clamp with it."""
    jcfg, tcfg, jp, tp = _model()
    jcache, tcache = _random_cache(jcfg, 2, 3)
    tokens = np.array([1, 2], np.int32)
    jlog, jcache2 = jl.decode_step(jcfg, jp, jcache, jnp.int32(pos),
                                   jnp.asarray(tokens))
    tlog, _ = tl.decode_step(tcfg, tp, tcache, pos, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol("fp32"))
    _cache_close(tcache, jcache2, _tol("fp32"))


@pytest.mark.parametrize("dtype,kv_quant,int8_weights", CASES, ids=IDS)
def test_prefill_and_trunk_match_jax(dtype, kv_quant, int8_weights):
    jcfg, tcfg, jp, tp = _model(dtype, kv_quant, int8_weights)
    prompt = _prompt(4, 2, 24)
    jcache, tcache = _random_cache(jcfg, 2, 5)
    jlog, jcache2 = jl.prefill(jcfg, jp, jcache, jnp.asarray(prompt))
    tlog, tcache2 = tl.prefill(tcfg, tp, tcache, torch.from_numpy(prompt))
    assert tcache2 is tcache
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol(dtype))
    _cache_close(tcache2, jcache2, _tol(dtype))
    jx, jks, jvs = jl.prefill_trunk(
        jcfg, jp, jnp.asarray(prompt),
        j_rope(jcfg.head_dim, MAX_SEQ, jcfg.rope_theta))
    tx, tks, tvs = tl.prefill_trunk(
        tcfg, tp, torch.from_numpy(prompt),
        t_rope(tcfg.head_dim, MAX_SEQ, tcfg.rope_theta, device="cpu"))
    assert tuple(tks.shape) == (2, 2, 24, 4, 8)
    for t, j in ((tx, jx), (tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **_tol(dtype))


def test_decode_chunk_logits_matches_jax():
    jcfg, tcfg, jp, tp = _model()
    jcache, tcache = _random_cache(jcfg, 2, 6)
    tokens = np.array([3, 4], np.int32)
    jt, jlog, _ = jl.decode_chunk_logits(jcfg, jp, jcache, jnp.int32(40),
                                         jnp.asarray(tokens), 5)
    tt, tlog, _ = tl.decode_chunk_logits(tcfg, tp, tcache, 40,
                                         torch.from_numpy(tokens), 5)
    assert tuple(tlog.shape) == (2, 5, 256)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol("fp32"))


@pytest.mark.parametrize("kv_quant,int8_weights",
                         [(False, False), (True, False), (False, True)])
def test_generate_matches_jax(kv_quant, int8_weights):
    jcfg, tcfg, jp, tp = _model("fp32", kv_quant, int8_weights)
    prompt = _prompt(7, 2, 12)
    want = np.asarray(jl.generate(jcfg, jp, jnp.asarray(prompt), 9))
    got = tl.generate(tcfg, tp, torch.from_numpy(prompt), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tl.generate_stepwise is tl.generate
    assert tuple(tl.generate(tcfg, tp, torch.from_numpy(prompt),
                             0).shape) == (2, 0)


@pytest.mark.parametrize("n,steps,chunk", [(12, 9, 4), (50, 14, 8),
                                           (3, 1, 16)])
def test_generate_chunked_matches_jax(n, steps, chunk):
    """(50, 14, 8): the last chunk runs 2 positions past max_seq; its
    writes clamp onto the last row after every kept token was
    computed."""
    jcfg, tcfg, jp, tp = _model()
    prompt = _prompt(8, 1, n)
    want = np.asarray(jl.generate_chunked(jcfg, jp, jnp.asarray(prompt),
                                          steps, chunk=chunk))
    got = tl.generate_chunked(tcfg, tp, torch.from_numpy(prompt), steps,
                              chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (1, steps)


def test_generate_refuses_an_ask_past_the_cache():
    _, tcfg, _, tp = _model()
    with pytest.raises(ValueError, match="exceeds the cache"):
        tl.generate_chunked(tcfg, tp, torch.zeros((1, 60), dtype=torch.int32),
                            5)


def test_quantize_params_matches_jax():
    jcfg, tcfg, jp, tp = _model("bf16")
    want = jax.device_get(jl.quantize_params(jp))
    got = tl.quantize_params(tp)
    assert set(got) == set(want) and set(got["layers"]) == \
        set(want["layers"])
    for name in ("attn_norm", "ffn_norm"):
        assert torch.equal(got["layers"][name], tp["layers"][name])
    pairs = [(got["embed"], want["embed"]), (got["lm_head"], want["lm_head"])]
    pairs += [(got["layers"][k], want["layers"][k])
              for k in got["layers"] if k not in ("attn_norm", "ffn_norm")]
    for t, j in pairs:
        assert isinstance(t, QTensor) and t.s.shape == j.s.shape
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.s.view(torch.int16).numpy(),
                                      np.asarray(j.s).view(np.int16))
    with pytest.raises(ValueError, match="dense decoder"):
        tl.quantize_params({**tp, "layers": {**tp["layers"], "router": 0}})


def test_init_kv_cache_shapes():
    for kv_quant in (False, True):
        jcfg, tcfg = (jl.LlamaConfig.tiny(kv_quant=kv_quant),
                      tl.LlamaConfig.tiny(kv_quant=kv_quant))
        want = jax.eval_shape(lambda: jl.init_kv_cache(jcfg, 3, 32))
        got = tl.init_kv_cache(tcfg, 3, 32, device="cpu")
        for side in ("k", "v"):
            if kv_quant:
                assert tuple(got[side].q.shape) == want[side].q.shape
                assert tuple(got[side].s.shape) == want[side].s.shape
            else:
                assert tuple(got[side].shape) == want[side].shape


@pytest.mark.parametrize("kv_quant", [False, True])
def test_flash_mode_slot_step_matches_dense_step(kv_quant):
    """``decode_attn='flash'`` runs the kernel wrapper (its plain version
    on CPU tensors) and the flash-attention prefill: a bf16 model with
    head_dim 64 matches the dense path within the bf16 tolerance."""
    cfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=MAX_SEQ, dim=256,
                              n_heads=4, n_kv_heads=2, kv_quant=kv_quant)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = torch.from_numpy(_prompt(9, 2, 20))
    out = {}
    for mode in ("flash", "dense"):
        c = dataclasses.replace(cfg, decode_attn=mode)
        cache = tl.init_kv_cache(c, 2, MAX_SEQ, device="cpu")
        _, cache = tl.prefill(c, params, cache, prompt)
        lengths = torch.tensor([20, 20], dtype=torch.int32)
        for step in range(6):
            out[mode], cache = tl.decode_step_slots(
                c, params, cache, lengths + step,
                torch.tensor([step, 3 * step], dtype=torch.int32))
    np.testing.assert_allclose(out["flash"].numpy(), out["dense"].numpy(),
                               rtol=0, atol=5e-2)


def test_flash_mode_refuses_shapes_outside_the_gate():
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=16, decode_attn="flash")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cache = tl.init_kv_cache(cfg, 1, 16, device="cpu")
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 8"):
        tl.decode_step_slots(cfg, params, cache, one, one)
