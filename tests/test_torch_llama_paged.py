"""The port's Llama serving subset (``dcos_commons_tpu_torch/models/
llama.py``) against the JAX reference: configs, parameter init and the
bridge, the page pool read/write, and the two paged forwards
(``decode_step_paged``, ``prefill_chunk_paged``) through
``params_from_jax``/``pool_from_jax`` on the same numpy inputs.

Tolerances: fp32 logits and pools within 1e-4 (two layers of fp32
matmuls summed in another order); bf16 logits within 5e-2 (bf16 matmul
outputs rounded at the same places in both, flips of one ulp carried
through two layers); int8 pool payloads within one quantization step
(a K/V value on a rounding boundary may round either way)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models.bridge import (params_from_jax,
                                                  pool_from_jax)
from dcos_commons_tpu_torch.ops.quant import QTensor

CPU = torch.device("cpu")
FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
          "ffn_dim", "max_seq", "rope_theta", "norm_eps", "head_dim")


def _cfgs(dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    base = dict(n_layers=2, max_seq=64)
    base.update(kw)
    return (jl.LlamaConfig.tiny(attn_impl="dense", dtype=jdt, **base),
            tl.LlamaConfig.tiny(dtype=tdt, **base))


def _np(x):
    if isinstance(x, QTensor):
        return x.q.numpy(), x.s.float().numpy()
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    if isinstance(x, jquant.QTensor):
        return np.asarray(x.q), np.asarray(x.s, np.float32)
    return np.asarray(x, np.float32)


def _pool_close(tpool, jpool, tol):
    for side in ("k", "v"):
        t, j = _np(tpool[side]), _np(jpool[side])
        if isinstance(t, tuple):
            assert np.abs(t[0].astype(int) - j[0].astype(int)).max() <= 1
            np.testing.assert_allclose(t[1], j[1], rtol=2e-2, atol=1e-6)
        else:
            np.testing.assert_allclose(t, j, **tol)


def _random_pool(jcfg, pages, ps, seed):
    """A JAX pool holding random K/V (what earlier steps wrote)."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, pages, ps, jcfg.n_kv_heads, jcfg.head_dim)
    sides = {s: jnp.asarray(rng.standard_normal(shape), jcfg.dtype)
             for s in ("k", "v")}
    if jcfg.kv_quant:
        sides = {s: jquant.quantize(x, axis=-1) for s, x in sides.items()}
    return sides


def _setup(dtype="fp32", kv_quant=False, ps=8, pages=13, seed=0):
    jcfg, tcfg = _cfgs(dtype, kv_quant=kv_quant)
    jp = jl.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    jpool = _random_pool(jcfg, pages, ps, seed + 1)
    tpool = pool_from_jax(jax.device_get(jpool), device="cpu")
    return jcfg, tcfg, jp, tp, jpool, tpool


@pytest.mark.parametrize("preset", ["llama3_8b", "llama_400m", "tiny"])
def test_presets_match_the_reference(preset):
    j = getattr(jl.LlamaConfig, preset)()
    t = getattr(tl.LlamaConfig, preset)()
    assert {f: getattr(t, f) for f in FIELDS} == \
        {f: getattr(j, f) for f in FIELDS}
    assert t.dtype == torch.bfloat16 and t.decode_attn == "auto"


def test_init_params_has_the_reference_tree():
    jcfg, tcfg = _cfgs("bf16", vocab_size=300)
    want = jax.eval_shape(lambda: jl.init_params(jcfg, jax.random.key(0)))
    got = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.bfloat16
    again = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(got["layers"]["wq"], again["layers"]["wq"])
    # scaled-normal: wq columns have std ~ dim ** -0.5
    std = got["layers"]["wq"].float().std().item()
    assert abs(std - tcfg.dim ** -0.5) < 0.2 * tcfg.dim ** -0.5


def test_init_params_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_page_pool(tcfg, 3, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(2, np.float32)})


def test_bridge_carries_bf16_and_int8_bit_exact():
    jcfg, _ = _cfgs("bf16")
    jp = jl.quantize_params(jl.init_params(jcfg, jax.random.key(3)))
    host = jax.device_get(jp)
    tp = params_from_jax(host, device="cpu")
    assert isinstance(tp["layers"]["wq"], QTensor)
    np.testing.assert_array_equal(tp["layers"]["wq"].q.numpy(),
                                  np.asarray(host["layers"]["wq"].q))
    bits = tp["layers"]["wq"].s.view(torch.int16).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(host["layers"]["wq"].s).view(np.int16))
    norm_bits = tp["norm"].view(torch.int16).numpy()
    np.testing.assert_array_equal(norm_bits,
                                  np.asarray(host["norm"]).view(np.int16))
    # a copy: writing the port's tensor leaves the JAX array alone
    tp["norm"].zero_()
    assert np.asarray(host["norm"], np.float32).min() == 1.0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_page_pool_shapes(kv_quant):
    jcfg, tcfg = _cfgs("bf16", kv_quant=kv_quant)
    want = jax.eval_shape(lambda: jl.init_page_pool(jcfg, 5, 8))
    got = tl.init_page_pool(tcfg, 5, 8, device="cpu")
    for side in ("k", "v"):
        if kv_quant:
            assert tuple(got[side].q.shape) == want[side].q.shape
            assert tuple(got[side].s.shape) == want[side].s.shape
            assert got[side].q.dtype == torch.int8
        else:
            assert tuple(got[side].shape) == want[side].shape
            assert got[side].dtype == torch.bfloat16


@pytest.mark.parametrize("kv_quant", [False, True])
def test_page_write_and_gather_match_jax(kv_quant):
    jcfg, tcfg, _, _, jpool, tpool = _setup(kv_quant=kv_quant)
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((4, jcfg.n_kv_heads, jcfg.head_dim)).astype(
        np.float32)
    phys = np.array([3, 3, 12, 0], np.int32)
    offs = np.array([0, 7, 2, 5], np.int32)
    jk = jl._page_write(jpool["k"][0] if not kv_quant else
                        jquant.QTensor(jpool["k"].q[0], jpool["k"].s[0]),
                        jnp.asarray(rows), jnp.asarray(phys),
                        jnp.asarray(offs))
    tk = tpool["k"][0]
    tl._page_write(tk, torch.from_numpy(rows), torch.from_numpy(phys),
                   torch.from_numpy(offs))
    _pool_close({"k": tk, "v": tk}, {"k": jk, "v": jk},
                dict(rtol=0, atol=0))
    table = np.array([[3, 12], [0, 5]], np.int32)
    got = tl._gather_pages(tk, torch.from_numpy(table), torch.float32)
    want = jl._gather_pages(jk, jnp.asarray(table), jnp.float32)
    assert tuple(got.shape) == (2, 16, jcfg.n_kv_heads, jcfg.head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2 if kv_quant else 0)


STEP_CASES = [("fp32", False), ("bf16", False), ("fp32", True)]


def _tol(dtype):
    return (dict(rtol=1e-4, atol=1e-4) if dtype == "fp32"
            else dict(rtol=0, atol=5e-2))


@pytest.mark.parametrize("dtype,kv_quant", STEP_CASES)
def test_decode_step_paged_matches_jax(dtype, kv_quant):
    """Four streams: one at a page boundary, one frozen with its length
    past the table (all-scratch row), mixed lengths elsewhere."""
    jcfg, tcfg, jp, tp, jpool, tpool = _setup(dtype, kv_quant)
    table = np.array([[0, 1, 2], [3, 4, 12], [5, 6, 7], [12, 12, 12]],
                     np.int32)
    lengths = np.array([17, 8, 23, 30], np.int32)
    tokens = np.array([5, 200, 31, 7], np.int32)
    jl_, jpool2 = jl.decode_step_paged(
        jcfg, jp, jpool, jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(tokens))
    tl_, tpool2 = tl.decode_step_paged(
        tcfg, tp, tpool, torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(tokens))
    assert tpool2 is tpool                       # written in place
    assert tl_.dtype == torch.float32 and tuple(tl_.shape) == (4, 256)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **_tol(dtype))
    _pool_close(tpool2, jpool2, _tol(dtype))


@pytest.mark.parametrize("dtype,kv_quant", STEP_CASES)
def test_prefill_chunk_paged_matches_jax(dtype, kv_quant):
    """A resumed chunk (start > 0) whose tail is padding: live rows land
    through the table, padded rows on the scratch page."""
    jcfg, tcfg, jp, tp, jpool, tpool = _setup(dtype, kv_quant)
    table = np.array([4, 9, 2, 11, 12, 12, 12, 12], np.int32)
    tokens = np.array([[3, 9, 27, 81, 243, 1, 2, 3]], np.int32)
    start, true_len, scratch = 12, 17, 12
    li = true_len - 1 - start
    jlog, jpool2 = jl.prefill_chunk_paged(
        jcfg, jp, jpool, jnp.asarray(table), jnp.asarray(tokens),
        jnp.int32(start), jnp.int32(true_len), jnp.int32(li), scratch)
    tlog, tpool2 = tl.prefill_chunk_paged(
        tcfg, tp, tpool, torch.from_numpy(table), torch.from_numpy(tokens),
        start, true_len, li, scratch)
    assert tuple(tlog.shape) == (1, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               **_tol(dtype))
    _pool_close(tpool2, jpool2, _tol(dtype))


def test_chunk_running_past_the_rope_table_matches_jax():
    """A chunk whose padded window overruns max_seq: only dead lanes
    saturate (the reference's per-lane ``apply_rope_positions``)."""
    jcfg, tcfg, jp, tp, jpool, tpool = _setup()
    table = np.arange(8, dtype=np.int32)
    tokens = np.arange(1, 9, dtype=np.int32)[None]
    start, true_len = 60, 63
    jlog, _ = jl.prefill_chunk_paged(
        jcfg, jp, jpool, jnp.asarray(table), jnp.asarray(tokens),
        jnp.int32(start), jnp.int32(true_len), jnp.int32(2), 12)
    tlog, _ = tl.prefill_chunk_paged(
        tcfg, tp, tpool, torch.from_numpy(table), torch.from_numpy(tokens),
        start, true_len, 2, 12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol("fp32"))


def test_decode_step_past_max_seq_matches_jax():
    """Lengths at and beyond max_seq (a retired stream still stepping in
    its window): no index error, same logits as the clamping reference."""
    jcfg, tcfg, jp, tp, jpool, tpool = _setup()
    table = np.array([[12] * 8, [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    lengths = np.array([64, 70], np.int32)
    tokens = np.array([1, 2], np.int32)
    jlog, _ = jl.decode_step_paged(jcfg, jp, jpool, jnp.asarray(table),
                                   jnp.asarray(lengths), jnp.asarray(tokens))
    tlog, _ = tl.decode_step_paged(tcfg, tp, tpool, torch.from_numpy(table),
                                   torch.from_numpy(lengths),
                                   torch.from_numpy(tokens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **_tol("fp32"))


def test_decode_attn_routing():
    _, tcfg = _cfgs()
    cpu = torch.device("cpu")
    assert not tl._use_flash_decode_paged(tcfg, cpu)              # auto
    assert tl._use_flash_decode_paged(tcfg, torch.device("cuda"))
    flash = dataclasses.replace(tcfg, decode_attn="flash")
    assert tl._use_flash_decode_paged(flash, cpu)
    dense = dataclasses.replace(tcfg, decode_attn="dense")
    assert not tl._use_flash_decode_paged(dense, torch.device("cuda"))
    with pytest.raises(ValueError, match="decode_attn"):
        tl._use_flash_decode_paged(
            dataclasses.replace(tcfg, decode_attn="pallas"), cpu)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_flash_decode_step_matches_dense_step(kv_quant):
    """``decode_attn='flash'`` runs the kernel wrapper (its plain version
    on CPU tensors) inside the model; it matches the dense gather within
    the bf16 tolerance (int8 pages: scales folded vs dequantized)."""
    _, tcfg = _cfgs("bf16", kv_quant=kv_quant, dim=256, n_heads=4,
                    n_kv_heads=2)
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = {}
    for mode in ("flash", "dense"):
        pool = tl.init_page_pool(tcfg, 6, 8, device="cpu")
        table = torch.tensor([[0, 1, 5], [2, 3, 4]], dtype=torch.int32)
        for step in range(12):
            lengths = torch.tensor([step, 2 * step], dtype=torch.int32)
            tokens = torch.tensor([step, 3 * step], dtype=torch.int32)
            out[mode], _ = tl.decode_step_paged(
                dataclasses.replace(tcfg, decode_attn=mode), params, pool,
                table, lengths, tokens)
    np.testing.assert_allclose(out["flash"].numpy(), out["dense"].numpy(),
                               rtol=0, atol=5e-2)


def test_flash_mode_refuses_shapes_outside_the_gate():
    _, tcfg = _cfgs("bf16", decode_attn="flash")          # head_dim 8
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pool = tl.init_page_pool(tcfg, 3, 8, device="cpu")
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 8"):
        tl.decode_step_paged(tcfg, params, pool,
                             torch.zeros((1, 2), dtype=torch.int32), one, one)
