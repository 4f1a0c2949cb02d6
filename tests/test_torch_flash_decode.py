"""The port's paged flash-decode module (``dcos_commons_tpu_torch/ops/
flash_decode.py``) on the CPU: its plain version against the JAX Pallas
kernel (interpret mode) and against the JAX dense paged read, its shape
gate, the wrapper's input checks, and the kernel build's bookkeeping.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.

Tolerances, each with its reason:

* vs the Pallas kernel: 2e-2. The TPU kernel rounds the probabilities
  to bf16 before ``p @ v``; the port keeps them in fp32.
* vs the JAX dense read, bf16 pages: one bf16 ulp (same fp32 math,
  summed in another order, rounded once to bf16).
* vs the JAX dense read, int8 pages: 2e-2. The dense read dequantizes
  K/V to bf16 before attention; the port folds the scales in fp32.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jllama
from dcos_commons_tpu.ops import attention as jattn
from dcos_commons_tpu.ops import flash_decode as jfd
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu_torch.kernels import build
from dcos_commons_tpu_torch.models import llama as tllama
from dcos_commons_tpu_torch.models.bridge import pool_from_jax
from dcos_commons_tpu_torch.ops import attention as tattn
from dcos_commons_tpu_torch.ops import flash_decode as tfd
from dcos_commons_tpu_torch.ops.quant import QTensor

LOOSE = dict(rtol=2e-2, atol=2e-2)
ULP = dict(rtol=2 ** -7, atol=1e-3)


def _inputs(seed, b, h, kv, d, ps, mp, int8):
    """Same numpy inputs for both frameworks: q, pools (bf16, or int8 +
    bf16 scales through the JAX quantizer), a shuffled page table."""
    rng = np.random.default_rng(seed)
    pages = b * mp + 1
    q = jnp.asarray(rng.standard_normal((b, 1, h, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((pages, ps, kv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((pages, ps, kv, d)), jnp.bfloat16)
    if int8:
        k, v = jquant.quantize(k, axis=-1), jquant.quantize(v, axis=-1)
    table = rng.permutation(pages)[:b * mp].reshape(b, mp).astype(np.int32)
    jx = {"q": q, "k": k, "v": v, "table": jnp.asarray(table)}
    tx = pool_from_jax(jax.device_get(jx), device="cpu")
    return jx, tx


def _ref(tx, kv_len):
    return tfd.flash_decode_paged_reference(
        tx["q"], tx["k"], tx["v"], tx["table"],
        torch.tensor(kv_len, dtype=torch.int32))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


@pytest.mark.parametrize("h,kv", [(2, 1), (8, 2)])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_version_matches_pallas_kernel(h, kv, int8):
    """At the JAX engine's flash shapes (D=128, ps=128)."""
    jx, tx = _inputs(0, 2, h, kv, 128, 128, 2, int8)
    kv_len = [200, 37]
    want = jfd.flash_decode_paged(jx["q"], jx["k"], jx["v"], jx["table"],
                                  jnp.asarray(kv_len, jnp.int32),
                                  interpret=True)
    got = _ref(tx, kv_len)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 1, h, 128)
    _close(got, want, LOOSE)


@pytest.mark.parametrize("int8", [False, True])
def test_plain_version_matches_jax_dense_paged_read(int8):
    """ps=16 (a page size the Pallas kernel cannot take): JAX
    ``_gather_pages`` + ``gqa_attention``, the dense decode read."""
    jx, tx = _inputs(1, 3, 8, 2, 64, 16, 4, int8)
    kv_len = [64, 1, 30]
    kr = jllama._gather_pages(jx["k"], jx["table"], jnp.bfloat16)
    vr = jllama._gather_pages(jx["v"], jx["table"], jnp.bfloat16)
    want = jattn.gqa_attention(jx["q"], kr, vr, causal=False,
                               kv_len=jnp.asarray(kv_len, jnp.int32))
    _close(_ref(tx, kv_len), want, LOOSE if int8 else ULP)


@pytest.mark.parametrize("int8", [False, True])
def test_plain_version_matches_port_dense_paged_read(int8):
    jx, tx = _inputs(2, 2, 4, 2, 128, 8, 5, int8)
    kv_len = torch.tensor([40, 13], dtype=torch.int32)
    kr = tllama._gather_pages(tx["k"], tx["table"], torch.bfloat16)
    vr = tllama._gather_pages(tx["v"], tx["table"], torch.bfloat16)
    want = tattn.gqa_attention(tx["q"], kr, vr, causal=False, kv_len=kv_len)
    got = tfd.flash_decode_paged_reference(tx["q"], tx["k"], tx["v"],
                                           tx["table"], kv_len)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **(LOOSE if int8 else ULP))


def test_lengths_past_the_table_and_empty_streams():
    """kv_len beyond MP * ps attends to the whole table (a frozen stream
    mid-window); kv_len 0 gives 0."""
    _, tx = _inputs(3, 3, 4, 1, 64, 4, 3, False)
    got = _ref(tx, [12, 500, 0])
    full = _ref(tx, [12, 12, 0])
    assert torch.equal(got[1], full[1])
    assert bool((got[2] == 0).all())


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    _, tx = _inputs(4, 2, 8, 2, 128, 16, 3, True)
    lens = torch.tensor([48, 5], dtype=torch.int32)
    before = tfd.flash_decode_paged.launches
    got = tfd.flash_decode_paged(tx["q"], tx["k"], tx["v"], tx["table"],
                                 lens)
    assert torch.equal(got, tfd.flash_decode_paged_reference(
        tx["q"], tx["k"], tx["v"], tx["table"], lens))
    assert tfd.flash_decode_paged.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, tx = _inputs(5, 2, 4, 2, 64, 8, 2, False)
    q, k, v, table = tx["q"], tx["k"], tx["v"], tx["table"]
    lens = torch.tensor([9, 3], dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16"):
        tfd.flash_decode_paged(q.float(), k, v, table, lens)
    with pytest.raises(TypeError, match="int32"):
        tfd.flash_decode_paged(q, k, v, table.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        tfd.flash_decode_paged(q, k, v, table.t().contiguous().t(), lens)
    with pytest.raises(TypeError, match="both"):
        tfd.flash_decode_paged(q, QTensor(k.to(torch.int8), k[..., :1]), v,
                               table, lens)
    with pytest.raises(ValueError, match="page_table"):
        tfd.flash_decode_paged(q, k, v, table[:1], lens)
    wide = torch.zeros((2, 1, 4, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        tfd.flash_decode_paged(wide, k, v, table, lens)


def test_wrapper_has_no_path_for_other_devices():
    """Only CPU tensors take the plain version; anything else launches
    the kernel or raises."""
    _, tx = _inputs(6, 1, 2, 1, 64, 4, 2, False)
    meta = {n: t.to("meta") for n, t in tx.items()}
    lens = torch.tensor([5], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfd.flash_decode_paged(meta["q"], meta["k"], meta["v"],
                               meta["table"], lens)


@pytest.mark.parametrize("d,h,kv,ps,sq,ok", [
    (128, 32, 8, 64, 1, True),       # the 8B serving shape
    (64, 8, 8, 1, 1, True),          # any page size
    (256, 16, 2, 7, 1, True),        # group 8
    (128, 18, 2, 64, 1, False),      # group 9
    (96, 4, 2, 64, 1, False),        # head_dim
    (128, 4, 2, 64, 2, False),       # two query positions
])
def test_supports_decode_paged_gate(d, h, kv, ps, sq, ok):
    q = torch.zeros((1, sq, h, d), dtype=torch.bfloat16)
    k = torch.zeros((2, ps, kv, d), dtype=torch.bfloat16)
    assert tfd.supports_decode_paged(q, k, ps) is ok


def test_kernel_build_bookkeeping():
    """One library per ``csrc/*.cu``, under ``build/torch_kernels`` (a
    gitignored directory), named by a digest of source, shared headers
    and flags; each source names the TPU kernels it replaces and its
    bound."""
    replaces = {"flash_attention_bwd": ("_bwd_dkdv_kernel", "_bwd_dq_kernel"),
                "flash_attention_fwd": ("_fwd_kernel",),
                "flash_decode_paged": ("_paged_kernel",)}
    assert build.sources() == sorted(replaces)
    assert build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    for name, kernels in replaces.items():
        lib = build.library_path(name)
        assert lib.parent == build.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-")
        src = (build.CSRC / f"{name}.cu").read_text()
        assert all(k in src for k in kernels) and "3.35 TB/s" in src
        assert "torch/extension.h" not in src


def test_nvcc_missing_is_a_clear_error(monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
