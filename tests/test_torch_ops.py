"""PyTorch port ops (``dcos_commons_tpu_torch/ops``) against the JAX
reference ops on the same numpy inputs: rms_norm, rope (including a
position past the table), GQA attention with vector offsets and lengths,
int8 quantization, and the sampling masks.

Tolerances: fp32 within 1e-5; bf16 within one bf16 ulp (both sides
compute in fp32 and round once, and the fp32 results may differ in the
last bits, which can flip that rounding): rtol 2^-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.ops import attention as jattn
from dcos_commons_tpu.ops import norms as jnorms
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu.ops import rotary as jrot
from dcos_commons_tpu.ops import sampling as jsamp
from dcos_commons_tpu_torch.models.bridge import tensor_from_numpy
from dcos_commons_tpu_torch.ops import attention as tattn
from dcos_commons_tpu_torch.ops import norms as tnorms
from dcos_commons_tpu_torch.ops import quant as tquant
from dcos_commons_tpu_torch.ops import rotary as trot
from dcos_commons_tpu_torch.ops import sampling as tsamp

CPU = torch.device("cpu")
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-3)
DTYPES = {"fp32": (jnp.float32, torch.float32, FP32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(a, jdt, tdt):
    """The same numpy values as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jdt)
    return j, tensor_from_numpy(np.asarray(j), CPU).to(tdt)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rms_norm_matches_jax(dt):
    jdt, tdt, tol = DTYPES[dt]
    xj, xt = _both(_rand(0, 2, 5, 64) * 3, jdt, tdt)
    wj, wt = _both(_rand(1, 64), jdt, tdt)
    out = tnorms.rms_norm(xt, wt, 1e-5)
    assert out.dtype == tdt
    _close(out, jnorms.rms_norm(xj, wj, 1e-5), tol)


def test_rope_frequencies_match_jax():
    want = jrot.rope_frequencies(32, 128, 500000.0)
    got = trot.rope_frequencies(32, 128, 500000.0, device="cpu")
    assert tuple(got.shape) == (2, 128, 16) and got.dtype == torch.float32
    _close(got, want, FP32)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_apply_rope_at_matches_jax_past_the_table(dt):
    """Positions past max_seq - 1 (a stream retired mid-window keeps
    advancing): JAX's gather clamps them, the port clamps explicitly."""
    jdt, tdt, tol = DTYPES[dt]
    table_j = jrot.rope_frequencies(16, 64)
    table_t = trot.rope_frequencies(16, 64, device="cpu")
    xj, xt = _both(_rand(2, 4, 1, 3, 16), jdt, tdt)
    pos = np.array([0, 17, 63, 90], np.int32)
    got = trot.apply_rope_at(xt, table_t, torch.from_numpy(pos))
    want = jrot.apply_rope_at(xj, table_j, jnp.asarray(pos))
    assert got.dtype == tdt
    _close(got, want, tol)
    # the clamped row equals the last row of the table
    last = trot.apply_rope_at(xt[3:], table_t, torch.tensor([63]))
    _close(got[3:], last.numpy() if dt == "fp32" else last.float().numpy(),
           dict(rtol=0, atol=0))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_apply_rope_positions_matches_jax(dt):
    jdt, tdt, tol = DTYPES[dt]
    table_j = jrot.rope_frequencies(16, 64)
    table_t = trot.rope_frequencies(16, 64, device="cpu")
    xj, xt = _both(_rand(3, 2, 8, 3, 16), jdt, tdt)
    pos = np.clip(np.arange(58, 66, dtype=np.int32), 0, 63)
    got = trot.apply_rope_positions(xt, table_t, torch.from_numpy(pos))
    _close(got, jrot.apply_rope_positions(xj, table_j, jnp.asarray(pos)),
           tol)


def test_repeat_kv_matches_jax():
    a = _rand(4, 2, 5, 3, 4)
    got = tattn.repeat_kv(torch.from_numpy(a), 4)
    want = jattn.repeat_kv(jnp.asarray(a), 4)
    assert tuple(got.shape) == (2, 5, 12, 4)
    _close(got, want, dict(rtol=0, atol=0))


ATTN_CASES = {
    "causal_scalar_offset": dict(causal=True, q_offset=3, kv_len=None),
    "causal_vector": dict(causal=True, q_offset=np.array([0, 5], np.int32),
                          kv_len=np.array([4, 9], np.int32)),
    "noncausal_kv_len": dict(causal=False, q_offset=0,
                             kv_len=np.array([1, 7], np.int32)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gqa_attention_matches_jax(case, dt):
    jdt, tdt, tol = DTYPES[dt]
    kw = ATTN_CASES[case]
    qj, qt = _both(_rand(5, 2, 4, 8, 16), jdt, tdt)
    kj, kt = _both(_rand(6, 2, 9, 2, 16), jdt, tdt)
    vj, vt = _both(_rand(7, 2, 9, 2, 16), jdt, tdt)

    def arg(x, conv):
        return conv(x) if isinstance(x, np.ndarray) else x

    got = tattn.gqa_attention(
        qt, kt, vt, causal=kw["causal"],
        q_offset=arg(kw["q_offset"], torch.from_numpy),
        kv_len=arg(kw["kv_len"], torch.from_numpy))
    want = jattn.gqa_attention(
        qj, kj, vj, causal=kw["causal"],
        q_offset=arg(kw["q_offset"], jnp.asarray),
        kv_len=arg(kw["kv_len"], jnp.asarray))
    assert got.dtype == tdt and tuple(got.shape) == (2, 4, 8, 16)
    _close(got, want, tol)


def test_quantize_matches_jax_bit_for_bit():
    w = _rand(8, 3, 16, 24)
    w[0, :, 0] = 0.0                                   # an all-zero channel
    for axis in (-2, -1):
        jq = jquant.quantize(jnp.asarray(w), axis=axis)
        tq = tquant.quantize(torch.from_numpy(w), axis=axis)
        assert tq.q.dtype == torch.int8 and tq.s.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        _close(tq.s, jq.s, dict(rtol=0, atol=0))
        _close(tquant.dequantize(tq, torch.float32),
               jquant.dequantize(jq, jnp.float32), dict(rtol=0, atol=0))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("quantized", [False, True])
def test_qmm_matches_jax(dt, quantized):
    jdt, tdt, tol = DTYPES[dt]
    xj, xt = _both(_rand(9, 2, 3, 32), jdt, tdt)
    wj, wt = _both(_rand(10, 32, 24) * 0.2, jdt, tdt)
    if quantized:
        wj, wt = jquant.quantize(wj), tquant.quantize(wt)
    got = tquant.qmm(xt, wt)
    assert got.dtype == tdt
    _close(got, jquant.qmm(xj, wj), tol)


@pytest.mark.parametrize("quantized", [False, True])
def test_qtake_matches_jax(quantized):
    table = _rand(11, 20, 8)
    wj, wt = jnp.asarray(table), torch.from_numpy(table)
    if quantized:
        wj, wt = jquant.quantize(wj, axis=-1), tquant.quantize(wt, axis=-1)
    idx = np.array([[0, 19, 5], [5, 5, 1]], np.int32)
    got = tquant.qtake(wt, torch.from_numpy(idx), torch.float32)
    _close(got, jquant.qtake(wj, jnp.asarray(idx), jnp.float32), FP32)


def test_qtensor_slices_both_payload_and_scales():
    qt = tquant.quantize(torch.from_numpy(_rand(12, 4, 8, 6)))
    layer = qt[2]
    assert tuple(layer.shape) == (8, 6) and tuple(layer.s.shape) == (1, 6)
    assert layer.dtype == torch.bfloat16
    assert torch.equal(layer.q, qt.q[2])


def test_top_k_mask_matches_jax():
    logits = _rand(13, 3, 50)
    logits[1, :5] = 2.5                                # ties at the threshold
    got = tsamp.top_k_mask(torch.from_numpy(logits), 5)
    want = jsamp.top_k_mask(jnp.asarray(logits), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9])
def test_top_p_mask_matches_jax(p):
    logits = _rand(14, 3, 50) * 2
    got = tsamp.top_p_mask(torch.from_numpy(logits), p)
    want = jsamp.top_p_mask(jnp.asarray(logits), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_sampler_greedy_and_validation():
    assert tsamp.make_sampler(0.0) is None
    with pytest.raises(ValueError, match="temperature"):
        tsamp.make_sampler(-1.0)
    with pytest.raises(ValueError, match="top_p"):
        tsamp.make_sampler(1.0, top_p=1.5)
    assert tsamp.make_sampler(0.7, top_k=3) == tsamp.make_sampler(0.7,
                                                                  top_k=3)


def test_sampler_draws_only_surviving_tokens_reproducibly():
    logits = torch.from_numpy(_rand(15, 4, 64))
    s = tsamp.make_sampler(1.0, top_k=3)
    draws = [s(torch.Generator().manual_seed(7), logits) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])             # seeded
    allowed = torch.topk(logits, 3, dim=-1).indices
    for _ in range(20):
        tok = s(None, logits)
        assert bool((allowed == tok[:, None]).any(dim=-1).all())


def test_rope_frequencies_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trot.rope_frequencies(16, 32)
