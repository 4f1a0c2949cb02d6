"""The port's flash attention (``dcos_commons_tpu_torch/ops/
flash_attention.py``) against the JAX reference on the same numpy inputs.

On CPU tensors the port runs its plain versions through the same
``torch.autograd.Function`` the CUDA kernels sit in; the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_flash_attention.py``
does. The cases mirror that file: single and multi block, GQA mapping,
uneven blocks, rectangular causal with ``q_offset``, head_dim 128, fully
masked rows, and the backward, multiblock and with an offset. Each
compares o, lse (row 0 of the TPU kernel's 8 copies) and dq/dk/dv.

Tolerance: fp32 within 2e-5 (both compute in fp32; sums run in another
order). The ragged S=511 case, which the JAX kernel refuses, is held
against JAX ``gqa_attention`` and its gradient, as are the edges of the
card kernel's tiles that the JAX kernel refuses (one query row, Sq=129
against Sk of 127, 129 and 257, a causal offset off the tile grid,
head_dim 64 and 256 at ragged lengths, a GQA group of 4 with ragged Sk,
Sk one past a key tile), with lse against a logsumexp in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.ops import flash_attention as jfa
from dcos_commons_tpu.ops.attention import gqa_attention
from dcos_commons_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5


def _inputs(b, sq, sk, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d))]


def _port(q, k, v, g, **kw):
    """Port forward + backward on CPU tensors: (o, lse, dq, dk, dv)."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, **kw)
    o.backward(torch.from_numpy(g))
    _, lse = tfa.flash_attention_fwd(qt.detach(), kt.detach(), vt.detach(),
                                     **kw)
    return [x.detach().numpy() for x in
            (o, lse, qt.grad, kt.grad, vt.grad)]


def _jax_flash(q, k, v, g, bq=128, bk=128, **kw):
    """JAX Pallas kernel in interpret mode: (o, lse, dq, dk, dv)."""
    with jax.default_matmul_precision("highest"):
        def f(q_, k_, v_):
            return jfa.flash_attention(q_, k_, v_, interpret=True,
                                       block_q=bq, block_k=bk, **kw)

        o, vjp = jax.vjp(f, q, k, v)
        dq, dk, dv = vjp(jnp.asarray(g))
        _, lse = jfa._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kw.get("causal", True), None, kw.get("q_offset", 0), bq, bk,
            True)
    return [np.asarray(x) for x in (o, lse[:, :, 0], dq, dk, dv)]


def _assert_all_close(got, want, tol=TOL):
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        assert err < tol, (name, err)


CASES = {
    # b, sq, sk, h, kv, d, causal, q_offset, block_q, block_k
    "single_block": (1, 128, 128, 4, 4, 64, False, 0, 128, 128),
    "causal_multi_block": (2, 256, 256, 8, 8, 64, True, 0, 128, 128),
    "gqa_head_mapping": (2, 256, 256, 8, 2, 64, True, 0, 128, 128),
    "uneven_blocks": (1, 256, 512, 4, 4, 64, False, 0, 64, 128),
    "rectangular_causal": (1, 128, 256, 4, 4, 64, True, 0, 64, 64),
    "head_dim_128": (1, 128, 128, 2, 2, 128, True, 0, 128, 128),
    "rectangular_causal_offset": (1, 128, 256, 4, 2, 32, True, 64, 64, 64),
    "backward_multiblock_negative_offset":
        (1, 128, 256, 4, 4, 32, True, -32, 64, 64),
    # the card kernel's edges inside the Pallas gate: a causal offset off
    # its 128-row tile grid, and head_dim 64 / 256 causal
    "causal_offset_off_tile": (1, 128, 384, 4, 2, 128, True, 77, 128, 128),
    "head_dim_64_causal_gqa4": (2, 128, 256, 8, 2, 64, True, 128, 64, 128),
    "head_dim_256_causal": (1, 128, 128, 2, 1, 256, True, 0, 64, 128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_backward_match_jax_kernel(case):
    b, sq, sk, h, kv, d, causal, off, bq, bk = CASES[case]
    q, k, v, g = _inputs(b, sq, sk, h, kv, d)
    got = _port(q, k, v, g, causal=causal, q_offset=off)
    want = _jax_flash(q, k, v, g, bq=bq, bk=bk, causal=causal, q_offset=off)
    _assert_all_close(got, want)


def test_fully_masked_rows_output_zero_lse_neg_and_zero_grad():
    # negative q_offset: rows at positions < 0 see no key
    q, k, v, g = _inputs(1, 64, 64, 2, 2, 32, seed=3)
    got = _port(q, k, v, g, causal=True, q_offset=-32)
    want = _jax_flash(q, k, v, g, bq=64, bk=64, causal=True, q_offset=-32)
    _assert_all_close(got, want)
    o, lse, dq = got[:3]
    assert float(np.abs(o[0, :32]).max()) == 0.0
    assert float(np.abs(o[0, 32:]).max()) > 0.0
    assert np.all(lse[0, :, :32] == np.float32(-1e30))
    assert float(np.abs(dq[0, :32]).max()) == 0.0


def test_every_row_dead_gives_zero_output_and_gradients():
    q, k, v, g = _inputs(1, 16, 32, 2, 1, 64, seed=4)
    o, lse, dq, dk, dv = _port(q, k, v, g, causal=True, q_offset=-40)
    assert not o.any() and not dq.any() and not dk.any() and not dv.any()
    assert np.all(lse == np.float32(-1e30))


@pytest.mark.parametrize("sq,sk,kv", [(511, 511, 2), (77, 200, 1)])
def test_ragged_lengths_match_dense_jax(sq, sk, kv):
    """S=511 (the train step's shape after the next-token shift): the
    JAX kernel refuses it (``supports``), the port's kernels mask it."""
    q, k, v, g = _inputs(2, sq, sk, 4, kv, 64, seed=5)
    assert not jfa.supports(jnp.asarray(q), jnp.asarray(k))
    off = sk - sq
    got = _port(q, k, v, g, causal=True, q_offset=off)
    with jax.default_matmul_precision("highest"):
        o, vjp = jax.vjp(lambda q_, k_, v_: gqa_attention(
            q_, k_, v_, causal=True, q_offset=off), q, k, v)
        grads = vjp(jnp.asarray(g))
    for name, a, b in zip(("o", "dq", "dk", "dv"),
                          [got[0]] + got[2:], [o, *grads]):
        err = float(np.abs(a - np.asarray(b)).max())
        assert err < TOL, (name, err)


# Edges of the card kernel's 128-row q tile and its K/V tiles that the
# Pallas gate refuses (Sq % 8, Sk % 128): the plain versions the card
# compares the kernel with are held against JAX's dense attention and its
# gradient, and lse against a logsumexp computed in JAX.
EDGE_CASES = {
    # b, sq, sk, h, kv, d, causal, q_offset
    "one_query_row_causal": (2, 1, 300, 8, 2, 128, True, 299),
    "one_query_row_full": (2, 1, 64, 4, 4, 64, False, 0),
    "sq129_sk127_two_dead_rows": (1, 129, 127, 4, 2, 128, True, -2),
    "sq129_sk129": (1, 129, 129, 4, 2, 128, True, 0),
    "sq129_sk257_causal": (1, 129, 257, 4, 2, 128, True, 128),
    "sq129_sk257_full": (1, 129, 257, 4, 2, 128, False, 0),
    "rectangular_offset_off_tile": (2, 300, 500, 8, 4, 128, True, 77),
    "head_dim_64_causal_ragged": (2, 300, 300, 8, 2, 64, True, 0),
    "head_dim_256_causal_ragged": (1, 300, 300, 4, 4, 256, True, 0),
    # the backward's tiles: a GQA group of 4 with ragged Sk, and Sk one
    # past a 128-key tile against one 64-row q tile
    "gqa4_ragged_sk": (1, 257, 385, 8, 2, 128, True, 128),
    "sk_one_past_key_tile": (1, 64, 129, 4, 2, 128, False, 0),
}


def _jax_lse(q, k, causal, off):
    """[B, H, Sq] logsumexp of the scaled scores in JAX; -1e30 where a row
    sees no key."""
    with jax.default_matmul_precision("highest"):
        n_rep = q.shape[2] // k.shape[2]
        kk = jnp.repeat(jnp.asarray(k), n_rep, axis=2)
        s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kk) \
            * q.shape[-1] ** -0.5
        if causal:
            live = (off + jnp.arange(q.shape[1]))[:, None] \
                >= jnp.arange(k.shape[1])[None, :]
            s = jnp.where(live, s, -jnp.inf)
        lse = jax.nn.logsumexp(s, axis=-1)
    return np.asarray(jnp.where(jnp.isinf(lse), -1e30, lse))


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_kernel_edge_shapes_match_dense_jax(case):
    b, sq, sk, h, kv, d, causal, off = EDGE_CASES[case]
    q, k, v, g = _inputs(b, sq, sk, h, kv, d, seed=7)
    assert not jfa.supports(jnp.asarray(q), jnp.asarray(k))
    # dense attention spreads a row that sees no key evenly over the keys;
    # the kernels give it 0: compare live rows, with no gradient from the
    # dead ones (dO 0 there), and pin the dead rows to 0 and -1e30
    dead = max(0, min(-off, sq)) if causal else 0
    g[:, :dead] = 0.0
    got = _port(q, k, v, g, causal=causal, q_offset=off)
    with jax.default_matmul_precision("highest"):
        o, vjp = jax.vjp(lambda q_, k_, v_: gqa_attention(
            q_, k_, v_, causal=causal, q_offset=off), q, k, v)
        grads = vjp(jnp.asarray(g))
    want = [np.asarray(x) for x in (o, _jax_lse(q, k, causal, off), *grads)]
    o_dead = got[0][:, :dead]
    got[0], want[0] = got[0][:, dead:], want[0][:, dead:]
    _assert_all_close(got, want)
    assert not o_dead.any()
    assert np.all(got[1][:, :, :dead] == np.float32(-1e30))


def test_backward_reference_matches_autograd_of_the_forward_reference():
    """The plain backward (from lse and delta) is the derivative of the
    plain forward, GQA group sums included (both fp32)."""
    q, k, v, g = (torch.from_numpy(x) for x in
                  _inputs(2, 40, 56, 6, 3, 32, seed=6))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_reference(qs, ks, vs, causal=True,
                                           q_offset=16)
    o.backward(g)
    dq, dk, dv = tfa.flash_attention_backward_reference(
        q, k, v, o.detach(), lse.detach(), g, causal=True, q_offset=16)
    for a, b in ((dq, qs.grad), (dk, ks.grad), (dv, vs.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)


def test_cpu_path_launches_no_kernel():
    q, k, v, g = _inputs(1, 8, 8, 2, 1, 64)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkdv.launches,
              tfa.flash_attention_bwd_dq.launches)
    _port(q, k, v, g)
    assert before == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_bwd_dkdv.launches,
                      tfa.flash_attention_bwd_dq.launches)


def test_supports_is_the_kernels_gate():
    def t(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    assert tfa.supports(t((16, 511, 12, 128)), t((16, 511, 6, 128)))
    assert tfa.supports(t((1, 5, 4, 64)), t((1, 3, 1, 64)))       # any S
    assert tfa.supports(t((1, 9, 2, 256)), t((1, 9, 2, 256)))
    assert not tfa.supports(t((1, 8, 4, 64), torch.float32),
                            t((1, 8, 4, 64), torch.float32))
    assert not tfa.supports(t((1, 8, 4, 96)), t((1, 8, 4, 96)))
    assert not tfa.supports(t((1, 8, 6, 64)), t((1, 8, 4, 64)))
    assert not tfa.supports(t((1, 8, 4, 64)), t((1, 8, 4, 128)))


def test_wrappers_refuse_bad_shapes_on_cpu():
    q = torch.zeros((1, 8, 6, 32))
    k = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(torch.zeros((1, 8, 4, 32)), k,
                                torch.zeros((1, 9, 4, 32)))
    q = torch.zeros((1, 8, 4, 32))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(q, k, k, q, lse, lse[:, :, :4])
