"""The port's speculative decoding pieces against the JAX package's, on
the same inputs at a small fp32 size: ``extend_step`` and
``verify_step_paged`` logits and the K/V rows they write (within 1e-5),
``truncate_layers``, ``rejection_step`` on the same p, q, x and RNG
state, ``SpeculativeDecoder``'s greedy and fused streams and its sampled
stream where the numpy RNG decides it, and the sealed draft artifact
(``save_draft``/``load_draft``) with every ``DraftIncompatible`` code."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import speculative as js
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import speculative as ts
from dcos_commons_tpu_torch.models.bridge import (params_from_jax,
                                                  pool_from_jax)
from dcos_commons_tpu_torch.ops.quant import QTensor
from dcos_commons_tpu_torch.parallel import checkpoint as tc

TOL = 1e-5
_MODELS = {}


def _model(seed=0, layers=2, max_seq=96):
    """(JAX cfg, port cfg, JAX params, port params), fp32, dense."""
    key = (seed, layers, max_seq)
    if key not in _MODELS:
        jcfg = jl.LlamaConfig.tiny(n_layers=layers, max_seq=max_seq,
                                   attn_impl="dense", dtype=jnp.float32)
        tcfg = tl.LlamaConfig.tiny(n_layers=layers, max_seq=max_seq,
                                   dtype=torch.float32)
        jp = jl.init_params(jcfg, jax.random.key(seed))
        _MODELS[key] = (jcfg, tcfg, jp,
                        params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[key]


def _toks(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------ model pieces


@pytest.mark.parametrize("pos", [8, 94])
def test_extend_step_matches_jax(pos):
    """A 4-token window after an 8-token prompt, and one that runs past
    the cache's end (its start clamps, as ``dynamic_update_slice``)."""
    jcfg, tcfg, jp, tp = _model()
    prompt = _toks(1, (2, 8))
    window = _toks(2, (2, 4))
    jcache = jl.init_kv_cache(jcfg, 2, jcfg.max_seq)
    _, jcache = jl.prefill(jcfg, jp, jcache, jnp.asarray(prompt))
    tcache = tl.init_kv_cache(tcfg, 2, tcfg.max_seq, device="cpu")
    _, tcache = tl.prefill(tcfg, tp, tcache, torch.from_numpy(prompt))
    jlog, jcache = jl.extend_step(jcfg, jp, jcache, jnp.asarray(window),
                                  jnp.int32(pos))
    tlog, tcache = tl.extend_step(tcfg, tp, tcache,
                                  torch.from_numpy(window), pos)
    assert tuple(tlog.shape) == (2, 4, tcfg.vocab_size)
    _close(jlog, tlog)
    lo = min(pos, tcfg.max_seq - 4)
    for side in ("k", "v"):
        _close(jcache[side][:, :, lo:lo + 4], tcache[side][:, :, lo:lo + 4])


def _paged_inputs(jcfg, tcfg, jp, tp, lengths, ps=16, mp=None,
                  kv_quant=False):
    """A pool prefilled through ``prefill_chunk_paged`` for streams of
    ``lengths`` (each on its own pages), in both packages."""
    pages_per = tcfg.max_seq // ps
    mp = mp or pages_per
    b = len(lengths)
    total = b * pages_per
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    tcfg = dataclasses.replace(tcfg, kv_quant=kv_quant)
    jpool = jl.init_page_pool(jcfg, total + 1, ps)
    table = np.arange(total, dtype=np.int32).reshape(b, pages_per)[:, :mp]
    for i, n in enumerate(lengths):
        prompt = _toks(10 + i, (1, 64))
        _, jpool = jl.prefill_chunk_paged(
            jcfg, jp, jpool, jnp.asarray(table[i]), jnp.asarray(prompt),
            jnp.int32(0), jnp.int32(n), jnp.int32(max(n - 1, 0)), total)
    tpool = pool_from_jax(jax.device_get(jpool), device="cpu")
    return jcfg, tcfg, jpool, tpool, table


@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_step_paged_matches_jax(kv_quant):
    """Streams at ragged lengths, one whose window crosses a page, one
    whose window runs past the table's span (its page index clips onto
    the last page) and one past ``max_seq`` (rope clamps)."""
    jcfg, tcfg, jp, tp = _model()
    lengths = np.array([5, 15, 60, 94], np.int32)
    jcfg, tcfg, jpool, tpool, table = _paged_inputs(
        jcfg, tcfg, jp, tp, [5, 15, 60, 64], mp=4, kv_quant=kv_quant)
    window = _toks(3, (4, 4))
    jlog, jpool = jl.verify_step_paged(jcfg, jp, jpool, jnp.asarray(table),
                                       jnp.asarray(lengths),
                                       jnp.asarray(window))
    tlog, tpool = tl.verify_step_paged(
        tcfg, tp, tpool, torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(window))
    assert tuple(tlog.shape) == (4, 4, tcfg.vocab_size)
    _close(jlog, tlog)
    want = pool_from_jax(jax.device_get(jpool), device="cpu")
    for side in ("k", "v"):
        a, b = want[side], tpool[side]
        if isinstance(a, QTensor):
            # rows may round to a neighbouring int8 step at a 1e-6 input
            # difference: hold the dequantized rows, not the payload
            a = a.q.float() * a.s.float()
            b = b.q.float() * b.s.float()
            _close(a, b, tol=2e-2)
        else:
            _close(a, b)


def test_verify_step_paged_equals_successive_decode_steps():
    """K rows through one verify == K successive paged decode steps (the
    window's K/V land where the solo rows would)."""
    jcfg, tcfg, jp, tp = _model()
    _, _, _, tpool, table = _paged_inputs(jcfg, tcfg, jp, tp, [7, 20])
    pool_b = {s: t.clone() for s, t in tpool.items()}
    lengths = torch.tensor([7, 20], dtype=torch.int32)
    window = torch.from_numpy(_toks(4, (2, 3)))
    tbl = torch.from_numpy(table)
    logits, tpool = tl.verify_step_paged(tcfg, tp, tpool, tbl, lengths,
                                         window)
    for j in range(3):
        lj, pool_b = tl.decode_step_paged(tcfg, tp, pool_b, tbl,
                                          lengths + j, window[:, j])
        _close(logits[:, j], lj, tol=1e-4)
    for side in ("k", "v"):
        _close(tpool[side], pool_b[side], tol=1e-4)


@pytest.mark.parametrize("quantized", [False, True])
def test_truncate_layers_is_a_view_of_the_first_layers(quantized):
    jcfg, tcfg, jp, tp = _model(layers=4)
    if quantized:
        tp = tl.quantize_params(tp)
    dcfg, dp = tl.truncate_layers(tcfg, tp, 2)
    jdcfg, jdp = jl.truncate_layers(jcfg, jp, 2)
    assert dcfg.n_layers == jdcfg.n_layers == 2
    assert dp["embed"] is tp["embed"] and dp["lm_head"] is tp["lm_head"]
    for name, w in dp["layers"].items():
        full = tp["layers"][name]
        for a, b in ([(w.q, full.q), (w.s, full.s)]
                     if isinstance(w, QTensor) else [(w, full)]):
            assert a.shape[0] == 2
            assert a.data_ptr() == b.data_ptr()           # a view
            assert torch.equal(a, b[:2])
    if not quantized:
        for name, w in jdp["layers"].items():
            _close(w, dp["layers"][name], tol=0)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="draft layers"):
            tl.truncate_layers(tcfg, tp, bad)


def test_rejection_step_matches_jax_on_the_same_rng_state():
    p = np.asarray([.35, .02, .13, .2, .05, .1, .05, .1])
    q = np.asarray([.02, .4, .02, .1, .3, .06, .05, .05])
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    got = [ts.rejection_step(p, q, x, ra) for x in range(8) for _ in range(50)]
    want = [js.rejection_step(p, q, x, rb) for x in range(8) for _ in range(50)]
    assert got == want
    assert {ok for _, ok in got} == {True, False}
    # the theorem, on the port's primitive: the emitted marginal is p
    rng = np.random.default_rng(0)
    counts = np.zeros(8)
    for _ in range(20000):
        tok, _ = ts.rejection_step(p, q, int(rng.choice(8, p=q)), rng)
        counts[tok] += 1
    np.testing.assert_allclose(counts / 20000, p, atol=0.015)


# ----------------------------------------------------- SpeculativeDecoder


def _decoders(k, temperature=0.0, seed=0, draft_seed=42, draft_layers=2):
    jcfg, tcfg, jp, tp = _model()
    jdcfg, tdcfg, jdp, tdp = _model(seed=draft_seed)
    if draft_layers != 2:
        jdcfg, jdp = jl.truncate_layers(jcfg, jp, draft_layers)
        jdp = jax.tree.map(jnp.array, jdp)
        tdcfg, tdp = tl.truncate_layers(tcfg, tp, draft_layers)
    return (js.SpeculativeDecoder(jcfg, jp, jdcfg, jdp, k=k,
                                  temperature=temperature, seed=seed),
            ts.SpeculativeDecoder(tcfg, tp, tdcfg, tdp, k=k,
                                  temperature=temperature, seed=seed,
                                  device="cpu"))


def _stats_core(stats):
    return {k: stats[k] for k in ("verify_passes", "proposed", "accepted",
                                  "k")}


@pytest.mark.parametrize("k,draft_layers", [(1, 2), (2, 2), (4, 2), (4, 1)])
def test_greedy_stream_equals_jax(k, draft_layers):
    jdec, tdec = _decoders(k, draft_layers=draft_layers)
    prompt = _toks(1, (1, 8))
    want, wstats = jdec.generate(jnp.asarray(prompt), 14)
    got, gstats = tdec.generate(torch.from_numpy(prompt), 14)
    assert got[0].tolist() == [int(t) for t in want[0]]
    assert _stats_core(gstats) == _stats_core(wstats)
    solo = tl.generate(tdec.cfg_t, tdec.params_t, torch.from_numpy(prompt),
                       14)
    assert got[0].tolist() == solo[0].tolist()


@pytest.mark.parametrize("k", [2, 4])
def test_fused_stream_equals_jax(k):
    jdec, tdec = _decoders(k)
    prompt = _toks(1, (1, 8))
    want, wstats = jdec.generate_fused(jnp.asarray(prompt), 13)
    got, gstats = tdec.generate_fused(torch.from_numpy(prompt), 13)
    assert got[0].tolist() == [int(t) for t in want[0]]
    assert gstats == wstats
    assert got[0].tolist() == tdec.generate(torch.from_numpy(prompt),
                                            13)[0][0].tolist()


def test_self_draft_accepts_everything():
    jcfg, tcfg, jp, tp = _model()
    dec = ts.SpeculativeDecoder(tcfg, tp, tcfg, tp, k=4, device="cpu")
    got, stats = dec.generate(torch.from_numpy(_toks(1, (1, 8))), 13)
    assert stats["accept_rate"] == 1.0 and stats["tokens_per_pass"] >= 3
    _, fstats = dec.generate_fused(torch.from_numpy(_toks(1, (1, 8))), 13)
    assert fstats["accept_rate"] == 1.0


@pytest.mark.parametrize("k,temperature", [(1, 1.0), (1, 0.7), (4, 1e-4)])
def test_sampled_stream_equals_jax_where_the_numpy_rng_decides(
        k, temperature):
    """With no draft step (k 1) every token is a draw of the seeded numpy
    RNG from the target's tempered distribution; at a near-zero
    temperature the draft's sampled proposals are its argmax, so the
    rejection tests, resamples and bonus draws take the reference's RNG
    path and stream."""
    jdec, tdec = _decoders(k, temperature=temperature, seed=11)
    prompt = _toks(1, (1, 8))
    want, wstats = jdec.generate(jnp.asarray(prompt), 12)
    got, gstats = tdec.generate(torch.from_numpy(prompt), 12)
    assert got[0].tolist() == [int(t) for t in want[0]]
    assert _stats_core(gstats) == _stats_core(wstats)


def test_sampled_self_draft_and_guards():
    jcfg, tcfg, jp, tp = _model()
    dec = ts.SpeculativeDecoder(tcfg, tp, tcfg, tp, k=4, temperature=1.0,
                                seed=7, device="cpu")
    got, stats = dec.generate(torch.from_numpy(_toks(1, (1, 8))), 16)
    assert stats["accept_rate"] == 1.0 and tuple(got.shape) == (1, 16)
    with pytest.raises(ValueError, match="greedy-only"):
        dec.generate_fused(torch.from_numpy(_toks(1, (1, 8))), 4)
    with pytest.raises(ValueError, match="batch-1"):
        dec.generate(torch.from_numpy(_toks(1, (2, 8))), 4)
    with pytest.raises(ValueError, match="exceeds"):
        dec.generate(torch.from_numpy(_toks(1, (1, 90))), 4)
    with pytest.raises(ValueError, match="vocabulary"):
        ts.SpeculativeDecoder(tcfg, tp, dataclasses.replace(
            tcfg, vocab_size=512), tp, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        ts.SpeculativeDecoder(tcfg, tp, tcfg, tp, k=0, device="cpu")


# ------------------------------------------------------ the draft artifact


def _bf16_draft():
    """A 1-layer bf16 draft (the artifact's default dtype) in both
    packages, from the JAX init."""
    jcfg = jl.LlamaConfig.tiny(n_layers=1, max_seq=64)
    jp = jl.init_params(jcfg, jax.random.key(3))
    tcfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64)
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), device="cpu")


def _tree_equal(a, b):
    for (ka, x), (kb, y) in zip(tc._flatten(a), tc._flatten(b)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y), ka


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_draft_artifact_round_trips_between_the_packages(tmp_path, writer):
    jcfg, tcfg, jp, tp = _bf16_draft()
    if writer == "port":
        ts.save_draft(str(tmp_path), 5, tcfg, tp, target_cfg=tcfg)
    else:
        js.save_draft(str(tmp_path), 5, jcfg, jp, target_cfg=jcfg)
    cfg_d, params_d, meta = ts.load_draft(str(tmp_path), tcfg, device="cpu")
    assert meta["step"] == 5 and cfg_d.n_layers == 1
    assert meta["target"]["vocab_size"] == 256
    _tree_equal(params_d, tp)
    jcfg_d, jparams_d, jmeta = js.load_draft(str(tmp_path), jcfg)
    assert jmeta == meta and jcfg_d.dim == cfg_d.dim
    _tree_equal(params_from_jax(jax.device_get(jparams_d), device="cpu"),
                tp)


def test_draft_config_json_is_the_reference_s(tmp_path):
    jcfg, tcfg, jp, tp = _bf16_draft()
    ts.save_draft(str(tmp_path / "t"), 2, tcfg, tp)
    js.save_draft(str(tmp_path / "j"), 2, jcfg, jp)
    for name in ("draft_config.json",
                 os.path.join("step-00000002-p0", "manifest.json")):
        a = (tmp_path / "t" / name).read_bytes()
        assert a == (tmp_path / "j" / name).read_bytes(), name


def _codes(tmp_path, tcfg, jcfg):
    """(port code, JAX code) of loading the artifact at ``tmp_path``."""
    out = []
    for load, cfg in ((lambda p, c: ts.load_draft(p, c, device="cpu"),
                       tcfg), (js.load_draft, jcfg)):
        with pytest.raises((ts.DraftIncompatible,
                            js.DraftIncompatible)) as e:
            load(str(tmp_path), cfg)
        out.append(e.value.code)
    return out


def test_draft_incompatible_codes_match_the_reference(tmp_path):
    jcfg, tcfg, jp, tp = _bf16_draft()
    assert _codes(tmp_path, tcfg, jcfg) == ["draft_config_missing"] * 2
    ts.save_draft(str(tmp_path), 1, tcfg, tp)
    for field, value, code in (
            ("vocab_size", 512, "draft_vocab_mismatch"),
            ("rope_theta", 1234.5, "draft_rope_mismatch"),
            ("max_seq", 128, "draft_max_seq")):
        assert _codes(tmp_path,
                      dataclasses.replace(tcfg, **{field: value}),
                      dataclasses.replace(jcfg, **{field: value})
                      ) == [code] * 2
    # a newer committed step: the sealed one is stale
    tc.save_sharded(str(tmp_path), 2, {"params": tp})
    assert _codes(tmp_path, tcfg, jcfg) == ["draft_manifest_stale"] * 2


@pytest.mark.parametrize("damage", ["manifest", "shard", "missing_shard"])
def test_a_changed_artifact_reads_stale(tmp_path, damage):
    jcfg, tcfg, jp, tp = _bf16_draft()
    step_dir = ts.save_draft(str(tmp_path), 1, tcfg, tp)
    if damage == "manifest":
        path = os.path.join(step_dir, "manifest.json")
        meta = json.load(open(path))
        meta["num_processes"] = 1
        with open(path, "w") as f:
            json.dump(meta, f, indent=1)
    elif damage == "shard":
        path = os.path.join(step_dir, "params.norm.o0.bin")
        raw = bytearray(open(path, "rb").read())
        raw[0] ^= 1
        open(path, "wb").write(raw)
    else:
        os.remove(os.path.join(step_dir, "params.lm_head.o0_0.bin"))
    assert _codes(tmp_path, tcfg, jcfg) == ["draft_manifest_stale"] * 2


def test_load_draft_template_draws_nothing(tmp_path):
    """The restore template is uninitialised tensors, not an init: the
    global torch RNG does not move."""
    jcfg, tcfg, jp, tp = _bf16_draft()
    ts.save_draft(str(tmp_path), 1, tcfg, tp)
    state = torch.get_rng_state()
    ts.load_draft(str(tmp_path), device="cpu")
    assert torch.equal(torch.get_rng_state(), state)
    template = tl.param_template(tcfg, device="cpu")
    assert [k for k, _ in tc._flatten(template)] == [
        k for k, _ in tc._flatten(tp)]
    assert all(a.shape == b.shape and a.dtype == b.dtype for (_, a), (_, b)
               in zip(tc._flatten(template), tc._flatten(tp)))
