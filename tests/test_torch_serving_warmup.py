"""``PagedServer.warmup``, the engines' static decode state and
``init_quantized_params`` in the port, against the JAX package where it
has a counterpart: warm-up's phases carry the reference's keys, write
nothing but the scratch page and change no later token; the tensors a
decode window reads or writes stay the same tensors across windows and
``reset`` (which zeroes them in place, so a fresh engine's tokens
follow); and the host-side int8 init equals quantizing the plain init."""

import jax
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.ops.quant import QTensor

KW = dict(slots=2, page_size=16, prefill_chunk=8)


def _tiny(**kw):
    cfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dtype=torch.float32,
                              **kw)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def _reqs(seed=0):
    rng = np.random.default_rng(seed)
    return [{"prompt": [int(t) for t in rng.integers(0, 256, n)],
             "max_new": m, "request_id": i}
            for i, (n, m) in enumerate([(8, 6), (21, 9), (5, 12), (30, 5)])]


def _pool_pages(pool):
    """Every page of a pool as numpy, K and V (payload and scales)."""
    out = []
    for side in ("k", "v"):
        t = pool[side]
        parts = (t.q, t.s) if isinstance(t, QTensor) else (t,)
        out += [p.float().numpy().copy() for p in parts]
    return out


@pytest.mark.parametrize("widths", [(1,), (1, 2), (4, 3, 1)])
def test_warmup_returns_the_reference_keys(widths):
    jcfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense")
    want = js.PagedServer(jcfg, jl.init_params(jcfg, jax.random.key(0)),
                          **KW).warmup(widths=widths)
    cfg, params = _tiny()
    got = ts.PagedServer(cfg, params, device="cpu", **KW).warmup(
        widths=widths)
    assert list(got) == list(want)
    assert all(v >= 0.0 for v in got.values())


@pytest.mark.parametrize("kv_quant", [False, True])
def test_warmup_writes_only_the_scratch_page(kv_quant):
    """Mid-service too: with streams decoding, warm-up changes no page but
    scratch, no length and no token, and the ledger stays clean."""
    cfg, params = _tiny(kv_quant=kv_quant)
    srv = ts.PagedServer(cfg, params, device="cpu", **KW)
    srv.submit_many(_reqs()[:2])
    for _ in range(5):
        srv.step()
    before = _pool_pages(srv.pool)
    lengths, toks = srv.lengths.clone(), srv.cur_tok.clone()
    srv.warmup(widths=(1, 2, 4))
    after = _pool_pages(srv.pool)
    for b, a in zip(before, after):
        np.testing.assert_array_equal(b[:, :srv.scratch], a[:, :srv.scratch])
    assert any(not np.array_equal(b[:, srv.scratch], a[:, srv.scratch])
               for b, a in zip(before, after))
    assert torch.equal(srv.lengths, lengths)
    assert torch.equal(srv.cur_tok, toks)
    assert srv.ledger_violations() == []


def test_warmup_changes_no_token():
    cfg, params = _tiny()
    cold = ts.PagedServer(cfg, params, device="cpu", **KW)
    warm = ts.PagedServer(cfg, params, device="cpu", **KW)
    warm.warmup(widths=(1, 2, 4))
    assert warm.drain(_reqs(), decode_window=4) == cold.drain(
        _reqs(), decode_window=4)
    assert warm.ledger_violations() == []


def test_warmup_refuses_a_width_outside_the_table():
    cfg, params = _tiny()
    srv = ts.PagedServer(cfg, params, device="cpu", **KW)
    for w in (0, srv.pages_per_stream + 1):
        with pytest.raises(ValueError, match="width"):
            srv.warmup(widths=(w,))


def _state(srv):
    kv = srv.pool if isinstance(srv, ts.PagedServer) else srv.cache
    ptrs = [srv.lengths.data_ptr(), srv.cur_tok.data_ptr(),
            srv._mask.data_ptr()]
    for t in kv.values():
        ptrs += [t.q.data_ptr(), t.s.data_ptr()] if isinstance(
            t, QTensor) else [t.data_ptr()]
    if isinstance(srv, ts.PagedServer):
        ptrs.append(srv._table_buf.data_ptr())
    return ptrs


@pytest.mark.parametrize("engine", ["paged", "slots"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_windows_and_reset_keep_the_static_tensors(engine, kv_quant):
    """A window writes its lengths and tokens into the same tensors, and
    ``reset`` zeroes them in place: after windows and a reset, the engine
    gives a fresh engine's tokens, on the same tensors throughout."""
    cfg, params = _tiny(kv_quant=kv_quant)

    def make():
        if engine == "paged":
            return ts.PagedServer(cfg, params, device="cpu", **KW)
        return ts.SlotServer(cfg, params, slots=2, device="cpu")

    srv = make()
    ptrs = _state(srv)
    first = srv.drain(_reqs(1), decode_window=3)
    assert _state(srv) == ptrs
    srv.submit_many(_reqs(2)[:2])
    srv.step_many(4)
    srv.reset()
    assert _state(srv) == ptrs
    assert int(srv.lengths.abs().sum()) == 0
    assert int(srv.cur_tok.abs().sum()) == 0
    assert srv.free_slots() == [0, 1] and srv.finished == {}
    assert srv.drain(_reqs(3), decode_window=4) == make().drain(
        _reqs(3), decode_window=4)
    assert _state(srv) == ptrs
    assert make().drain(_reqs(1), decode_window=3) == first


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_quantized_params_equals_quantizing_the_plain_init(kv_quant):
    cfg = tl.LlamaConfig.tiny(n_layers=2, kv_quant=kv_quant)
    got = tl.init_quantized_params(cfg, torch.Generator().manual_seed(7),
                                   device="cpu")
    want = tl.quantize_params(tl.init_params(
        cfg, torch.Generator().manual_seed(7), device="cpu"))

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            elif isinstance(v, QTensor):
                yield f"{prefix}{k}.q", v.q
                yield f"{prefix}{k}.s", v.s
            else:
                yield f"{prefix}{k}", v

    g, w = dict(leaves(got)), dict(leaves(want))
    assert list(g) == list(w)
    for name in g:
        assert g[name].dtype == w[name].dtype, name
        assert torch.equal(g[name], w[name]), name
    assert isinstance(got["layers"]["wq"], QTensor)
    assert got["layers"]["wq"].q.dtype == torch.int8
