"""The port's slot-cache flash-decode (``flash_decode`` in
``dcos_commons_tpu_torch/ops/flash_decode.py``) on the CPU: its plain
version against the JAX Pallas kernel (interpret mode) and the JAX dense
decode read, the ``kv_len`` forms and their clamps, the shape gate and
the wrapper's refusals. The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py``.

Tolerances, each with its reason:

* vs the Pallas kernel: 2e-2. The TPU kernel rounds ``p * s_v`` to bf16
  before ``p @ v``, block by block against its running max; the plain
  version keeps it in fp32 against the global max, so even fp32 inputs
  differ in the last bits of bf16.
* vs the JAX dense read, bf16 cache: one bf16 ulp (the same fp32 math,
  summed in another order, rounded once to bf16).
* vs the JAX dense read, int8 cache: 2e-2. The dense read dequantizes
  K/V to bf16 before attention; the plain version folds the scales in
  fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.ops import attention as jattn
from dcos_commons_tpu.ops import flash_decode as jfd
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu_torch.models.bridge import cache_from_jax
from dcos_commons_tpu_torch.ops import flash_decode as tfd
from dcos_commons_tpu_torch.ops.quant import QTensor

LOOSE = dict(rtol=2e-2, atol=2e-2)
ULP = dict(rtol=2 ** -7, atol=1e-3)


def _inputs(seed, b, s, h, kv, d, int8):
    """Same numpy inputs for both frameworks: q and a slot cache (bf16, or
    int8 + bf16 scales through the JAX quantizer)."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((b, 1, h, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, s, kv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, kv, d)), jnp.bfloat16)
    if int8:
        k, v = jquant.quantize(k, axis=-1), jquant.quantize(v, axis=-1)
    jx = {"q": q, "k": k, "v": v}
    return jx, cache_from_jax(jax.device_get(jx), device="cpu")


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def _lens(kv_len):
    if isinstance(kv_len, int):
        return kv_len, jnp.int32(kv_len)
    return (torch.tensor(kv_len, dtype=torch.int32),
            jnp.asarray(kv_len, jnp.int32))


@pytest.mark.parametrize("h,kv", [(2, 2), (8, 2), (8, 1)])   # group 1, 4, 8
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kv_len", [200, [1, 256, 300]],
                         ids=["scalar", "per_slot_1_S_past_S"])
def test_plain_version_matches_pallas_kernel(h, kv, int8, kv_len):
    """At the Pallas kernel's shapes (S % 128 == 0, D = 128)."""
    jx, tx = _inputs(0, 3, 256, h, kv, 128, int8)
    t_len, j_len = _lens(kv_len)
    want = jfd.flash_decode(jx["q"], jx["k"], jx["v"], j_len,
                            interpret=True)
    got = tfd.flash_decode_reference(tx["q"], tx["k"], tx["v"], t_len)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 1, h, 128)
    _close(got, want, LOOSE)


@pytest.mark.parametrize("int8", [False, True])
def test_plain_version_matches_jax_dense_read(int8):
    """S=100, D=64 (shapes the Pallas kernel cannot take): JAX
    ``gqa_attention`` over the dequantized cache, the dense decode read."""
    jx, tx = _inputs(1, 3, 100, 8, 2, 64, int8)
    kv_len = [100, 1, 37]
    k, v = jx["k"], jx["v"]
    if int8:
        k = jquant.dequantize(k, jnp.bfloat16)
        v = jquant.dequantize(v, jnp.bfloat16)
    want = jattn.gqa_attention(jx["q"], k, v, causal=False,
                               kv_len=jnp.asarray(kv_len, jnp.int32))
    got = tfd.flash_decode_reference(
        tx["q"], tx["k"], tx["v"], torch.tensor(kv_len, dtype=torch.int32))
    _close(got, want, LOOSE if int8 else ULP)


def test_kv_len_forms_and_clamps():
    """An int, a 0-d tensor, a [1] tensor and a [B] tensor of one value
    agree; a length past S attends to the whole cache; 0 or less gives 0."""
    _, tx = _inputs(2, 3, 40, 4, 2, 64, True)
    q, k, v = tx["q"], tx["k"], tx["v"]
    ref = tfd.flash_decode_reference
    base = ref(q, k, v, torch.tensor([17] * 3, dtype=torch.int32))
    for form in (17, torch.tensor(17, dtype=torch.int32),
                 torch.tensor([17], dtype=torch.int32)):
        assert torch.equal(ref(q, k, v, form), base)
    past = ref(q, k, v, torch.tensor([40, 900, 2 ** 31 - 1],
                                     dtype=torch.int32))
    full = ref(q, k, v, 40)
    assert torch.equal(past, full)
    assert torch.equal(ref(q, k, v, 10 ** 12), full)       # saturates
    dead = ref(q, k, v, torch.tensor([0, -5, 3], dtype=torch.int32))
    assert bool((dead[:2] == 0).all()) and bool((dead[2] != 0).any())


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    _, tx = _inputs(3, 2, 64, 8, 2, 128, True)
    lens = torch.tensor([48, 5], dtype=torch.int32)
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(tx["q"], tx["k"], tx["v"], lens)
    assert torch.equal(got, tfd.flash_decode_reference(
        tx["q"], tx["k"], tx["v"], lens))
    assert tfd.flash_decode.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, tx = _inputs(4, 2, 16, 4, 2, 64, False)
    q, k, v = tx["q"], tx["k"], tx["v"]
    lens = torch.tensor([9, 3], dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16"):
        tfd.flash_decode(q.float(), k, v, lens)
    with pytest.raises(TypeError, match="int32"):
        tfd.flash_decode(q, k, v, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        tfd.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                         v, lens)
    with pytest.raises(TypeError, match="both"):
        tfd.flash_decode(q, QTensor(k.to(torch.int8), k[..., :1]), v, lens)
    with pytest.raises(ValueError, match="one cache row per query"):
        tfd.flash_decode(q, k[:1], v[:1], lens)
    with pytest.raises(ValueError, match="1 or B=2"):
        tfd.flash_decode(q, k, v, torch.tensor([1, 2, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="of one shape"):
        tfd.flash_decode(q, k, v[:, :8].contiguous(), lens)
    wide = torch.zeros((2, 1, 4, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        tfd.flash_decode(wide, k, v, lens)


def test_wrapper_has_no_path_for_other_devices():
    """Only CPU tensors take the plain version; anything else launches
    the kernel or raises."""
    _, tx = _inputs(5, 1, 8, 2, 1, 64, False)
    meta = {n: t.to("meta") for n, t in tx.items()}
    with pytest.raises(ValueError, match="no kernel"):
        tfd.flash_decode(meta["q"], meta["k"], meta["v"], 5)


@pytest.mark.parametrize("d,h,kv,s,sq,ok", [
    (128, 32, 8, 2048, 1, True),     # the 8B slot shape
    (64, 8, 8, 1, 1, True),          # any cache length
    (256, 16, 2, 100, 1, True),      # group 8, S not lane-aligned
    (128, 18, 2, 64, 1, False),      # group 9
    (96, 4, 2, 64, 1, False),        # head_dim
    (128, 4, 2, 64, 2, False),       # two query positions
    (128, 4, 2, 0, 1, False),        # an empty cache
])
def test_supports_decode_gate(d, h, kv, s, sq, ok):
    q = torch.zeros((1, sq, h, d), dtype=torch.bfloat16)
    k = torch.zeros((1, s, kv, d), dtype=torch.bfloat16)
    assert tfd.supports_decode(q, k) is ok
