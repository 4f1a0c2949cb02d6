"""The port's block-paged engine (``dcos_commons_tpu_torch/models/
serving.py:PagedServer``) against the JAX ``PagedServer``: token-exact
``drain()`` on the request sets of ``tests/test_serving_paged.py``
(solo, windowed, no prefix cache, pages-bound admission, int8 KV), plus
prefix sharing with the boundary copy-on-write, EOS, a window that runs
past ``max_seq``, and one bf16 engine. The fp32 tiny model makes the
comparison one of the algorithm; the ledger must stay clean and page
hashes byte-identical to the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import paging as jpaging
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import paging as tpaging
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.ops.sampling import make_sampler
from dcos_commons_tpu_torch.parallel.moe import MoEConfig

_MODELS = {}


def _model(dtype="fp32", kv_quant=False):
    """(JAX cfg, port cfg, JAX params, port params) of the tiny 2-layer
    engine model the JAX paged tests use, weights from ``key(0)``."""
    key = (dtype, kv_quant)
    if key not in _MODELS:
        jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        jcfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                                   dtype=jdt, kv_quant=kv_quant)
        tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dtype=tdt,
                                   kv_quant=kv_quant)
        jp = jl.init_params(jcfg, jax.random.key(0))
        _MODELS[key] = (jcfg, tcfg, jp,
                        params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[key]


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _both(reqs, dtype="fp32", kv_quant=False, window=1, **kw):
    """Drain ``reqs`` through both engines; returns (jax, port, port
    engine)."""
    jcfg, tcfg, jp, tp = _model(dtype, kv_quant)
    want = js.PagedServer(jcfg, jp, **kw).drain(
        [dict(r) for r in reqs], decode_window=window)
    srv = ts.PagedServer(tcfg, tp, device="cpu", **kw)
    got = srv.drain([dict(r) for r in reqs], decode_window=window)
    assert srv.ledger_violations() == []
    return want, got, srv


SOLO = [(8, 6), (5, 9), (12, 4), (20, 7)]


@pytest.mark.parametrize("window", [1, 4])
def test_drain_matches_jax(window):
    reqs = [{"prompt": _prompt(40 + i, n), "max_new": m, "request_id": i}
            for i, (n, m) in enumerate(SOLO)]
    want, got, _ = _both(reqs, window=window, slots=2, page_size=16,
                         prefill_chunk=8)
    assert got == want


def _shared_prefix_reqs():
    base = _prompt(50, 20)
    return [{"prompt": base, "max_new": 5, "request_id": "a"},
            {"prompt": base[:16] + _prompt(51, 4), "max_new": 6,
             "request_id": "b"},
            {"prompt": base, "max_new": 4, "request_id": "c"}]


def test_drain_without_prefix_cache_matches_jax():
    want, got, srv = _both(_shared_prefix_reqs(), slots=2, page_size=8,
                           prefill_chunk=8, prefix_cache=False)
    assert got == want
    assert srv.page_stats()["prefix_hits"] == 0


def test_prefix_sharing_and_boundary_copy_match_jax():
    """One slot, so every request admits after the previous retired:
    "b" shares two full pages of "a", and "c" (= "a") also copies the
    partial boundary page before prefilling only its last token."""
    reqs = _shared_prefix_reqs()
    want, got, srv = _both(reqs, slots=1, page_size=8, prefill_chunk=8)
    assert got == want
    stats = srv.page_stats()
    assert stats["prefix_hits"] == 2 and stats["prefix_shared_pages"] == 4


def test_admission_is_page_bound_and_matches_jax():
    """With the pool sized for two streams, four free slots admit two;
    the backlog completes once pages recycle."""
    jcfg, tcfg, jp, tp = _model()
    reqs = [{"prompt": _prompt(60 + i, 40), "max_new": 20, "request_id": i}
            for i in range(4)]
    kw = dict(slots=4, pages=8, page_size=16, prefill_chunk=16)
    srv = ts.PagedServer(tcfg, tp, device="cpu", **kw)
    placed = srv.submit_many([dict(r) for r in reqs])
    assert len(placed) == 2 and len(srv.free_slots()) == 2
    assert srv.pages_free() == 0
    got = srv.drain([dict(r) for r in reqs[2:]])
    want = js.PagedServer(jcfg, jp, **kw).drain([dict(r) for r in reqs])
    assert got == want
    assert srv.ledger_violations() == []
    assert srv.page_stats()["pages_in_use_peak"] == 8


@pytest.mark.parametrize("window", [1, 4])
def test_int8_kv_drain_matches_jax(window):
    reqs = [{"prompt": _prompt(70 + i, n), "max_new": m, "request_id": i}
            for i, (n, m) in enumerate([(8, 5), (14, 6), (30, 9)])]
    want, got, _ = _both(reqs, kv_quant=True, window=window, slots=2,
                         page_size=16, prefill_chunk=8)
    assert got == want


BF16_REQS = [{"prompt": _prompt(200 + i, n), "max_new": m, "request_id": i}
             for i, (n, m) in enumerate([(8, 6), (17, 5), (3, 8)])]


def test_bf16_drain_matches_jax():
    """The working dtype. bf16 logits of the two frameworks agree within
    a few ulps (``test_torch_llama_paged.py`` holds them to 5e-2), so a
    one-ulp tie between the top two tokens can flip the argmax: like the
    reference's own suite, this uses a set whose argmaxes are tie-free
    (two of the ten neighbouring seed sets are not)."""
    reqs = BF16_REQS
    want, got, _ = _both(reqs, dtype="bf16", window=2, slots=2,
                         page_size=16, prefill_chunk=8)
    assert got == want


def test_eos_retires_like_jax():
    jcfg, tcfg, jp, tp = _model()
    reqs = [{"prompt": _prompt(90 + i, n), "max_new": 12, "request_id": i}
            for i, n in enumerate([6, 11, 9])]
    first = js.PagedServer(jcfg, jp, slots=3, page_size=16,
                           prefill_chunk=8).drain([dict(r) for r in reqs])
    eos = first[1][3]                     # a token stream 1 emits
    want, got, _ = _both(reqs, eos_id=eos, window=4, slots=2, page_size=16,
                         prefill_chunk=8)
    assert got == want
    assert got[1][-1] == eos and len(got[1]) == 4


def test_window_past_max_seq_matches_jax():
    """A stream retiring at max_seq inside an 8-step window keeps
    stepping past the table and the rope range; the reference clamps
    silently, the port explicitly, with no index error."""
    reqs = [{"prompt": _prompt(95, 58), "max_new": 6, "request_id": "long"},
            {"prompt": _prompt(96, 5), "max_new": 20, "request_id": "short"}]
    want, got, _ = _both(reqs, window=8, slots=2, page_size=16,
                         prefill_chunk=16)
    assert got == want
    assert len(got["long"]) == 6


def test_flash_mode_engine_matches_dense_engine():
    """``decode_attn='flash'`` routes decode through the kernel wrapper
    (its plain version on CPU tensors): a bf16 engine with head_dim 64
    (inside the kernel's gate) emits the dense engine's tokens."""
    tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dim=256, n_heads=4,
                               n_kv_heads=2)
    tp = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    out = {}
    for mode in ("dense", "flash"):
        cfg = dataclasses.replace(tcfg, decode_attn=mode)
        out[mode] = ts.PagedServer(
            cfg, tp, slots=2, page_size=16, prefill_chunk=8,
            device="cpu").drain([dict(r) for r in BF16_REQS],
                                decode_window=2)
    assert out["flash"] == out["dense"]


@pytest.mark.parametrize("ps", [1, 4, 16])
def test_page_hashes_are_byte_identical(ps):
    for seed, n in [(1, 0), (2, 3), (3, 16), (4, 37)]:
        prompt = _prompt(seed, n, vocab=128256)
        assert tpaging.page_hashes(prompt, ps) == \
            jpaging.page_hashes(prompt, ps)


def test_ledger_hygiene_through_abort_and_reset():
    _, tcfg, _, tp = _model()
    srv = ts.PagedServer(tcfg, tp, slots=2, page_size=8, prefill_chunk=8,
                         device="cpu")
    srv.drain([{"prompt": _prompt(100, 20), "max_new": 3,
                "request_id": "warm"}])
    held = srv.radix.held()
    assert len(held) == 2                         # full prompt pages adopted
    srv.submit(_prompt(101, 30), max_new=10, request_id="x")
    srv.submit(_prompt(102, 12), max_new=10, request_id="y")
    assert srv.submit(_prompt(103, 4)) is None    # no free stream
    srv.step()
    assert srv.ledger_violations() == []
    assert srv.abort_active() == 2
    assert srv.ledger_violations() == []
    assert srv.pages_free() == srv.total_pages - len(held)
    srv.reset()
    assert srv.pages_free() == srv.total_pages and srv.finished == {}
    assert srv.ledger_violations() == []


def test_ledger_reconcile_reclaims_leaked_pages():
    pool = tpaging.PagePool(6, 4)
    pages = pool.alloc(3)
    pool.ref(pages[0])
    assert pool.check({pages[0]: 1, pages[1]: 1, pages[2]: 1}) != []
    assert pool.reconcile({pages[0]: 2, pages[1]: 1}) == [pages[2]]
    assert pool.check({pages[0]: 2, pages[1]: 1}) == []
    with pytest.raises(tpaging.PageLedgerError):
        pool.unref(pages[2])


def test_admission_validation():
    _, tcfg, _, tp = _model()
    srv = ts.PagedServer(tcfg, tp, slots=2, pages=3, page_size=16,
                         prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        srv.submit([])
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit(_prompt(1, 60), max_new=10)
    with pytest.raises(ValueError, match="pages"):
        srv.submit(_prompt(1, 40), max_new=20)     # 4 pages > pool of 3
    bad = []
    placed = srv.submit_many(
        [{"prompt": [], "request_id": "bad"},
         {"prompt": _prompt(2, 5), "max_new": 3, "request_id": "ok"}],
        on_invalid=lambda item, reason: bad.append(item["request_id"]))
    assert bad == ["bad"] and [rid for _, rid in placed] == ["ok"]


def _cuda_rank():
    """Rank 0 of a tp=2 process mesh on a CUDA device (no process
    group: the engine refuses it before any collective)."""
    from dcos_commons_tpu_torch.parallel.mesh import Mesh
    return Mesh({"dp": 1, "pp": 1, "sp": 1, "tp": 2, "ep": 1},
                {"dp": 0, "pp": 0, "sp": 0, "tp": 0, "ep": 0},
                torch.device("cuda"), "nccl", rank=0)


@pytest.mark.parametrize("kw", [
    dict(moe=MoEConfig(4)),
    dict(longctx_ring=2), dict(mesh=_cuda_rank()),
    dict(key=object())])
def test_constructor_refuses_features_not_ported(kw):
    """No such parameter (TypeError); ``moe`` is ported, and refused with
    dense weights, which carry no router (ValueError); ``mesh`` is ported
    (``tests/test_torch_tp.py``), and refused on another device type than
    the engine's (ValueError); ``longctx_ring`` is ported
    (``tests/test_torch_ring_prefill.py``), and refused without a mesh
    whose sp axis is the ring's size (ValueError)."""
    _, tcfg, _, tp = _model()
    with pytest.raises(ValueError if {"moe", "mesh", "longctx_ring"} & set(kw)
                       else TypeError):
        ts.PagedServer(tcfg, tp, device="cpu", **kw)


def test_constructor_checks_geometry_and_device():
    _, tcfg, _, tp = _model()
    with pytest.raises(ValueError, match="divide"):
        ts.PagedServer(tcfg, tp, page_size=24, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        ts.PagedServer(tcfg, tp, prefill_chunk=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.PagedServer(tcfg, tp)


def test_sampled_engine_emits_valid_tokens():
    _, tcfg, _, tp = _model()
    srv = ts.PagedServer(tcfg, tp, slots=2, page_size=16, prefill_chunk=8,
                         sampler=make_sampler(0.8, top_k=20),
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")
    got = srv.drain([{"prompt": _prompt(110 + i, 6), "max_new": 7,
                      "request_id": i} for i in range(3)], decode_window=3)
    assert sorted(got) == [0, 1, 2]
    assert all(len(t) == 7 and all(0 <= x < 256 for x in t)
               for t in got.values())
