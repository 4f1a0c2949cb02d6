"""Port tests that need the card: the paged flash-decode CUDA kernel
against its plain PyTorch version across shapes, page sizes and int8
pages, and the paged engine running through it; the slot-cache
flash-decode kernel against its plain version (int8, kv_len 0 and past
the cache, head_dim 64/128/256), its refusals, and ``SlotServer`` and
solo decode running through it; the flash-attention
forward, dK/dV and dQ kernels against their plain versions (the smoke
run's shapes, ragged and negative-offset cases, one query row, Sq
around the forward's 128-row tile, head_dim 64 and 256, the B=8
slot-prefill bucket, and the edges of the backward's tiles), the run-to-
run determinism and any softmax scale of the forward and of the
backward, their refusals, and the train step running through them.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from dcos_commons_tpu_torch.models import llama, serving, train
from dcos_commons_tpu_torch.ops import flash_attention as fa
from dcos_commons_tpu_torch.ops import flash_decode as fd
from dcos_commons_tpu_torch.ops.quant import QTensor, quantize

pytestmark = pytest.mark.cuda

# both accumulate in fp32 and round once to bf16: about one bf16 ulp
RTOL, ATOL = 1e-2, 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, b, h, kv, d, ps, mp, kv_len, int8, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = b * mp + 2
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((pages, ps, kv, d), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((pages, ps, kv, d), generator=g,
                    device=dev).to(torch.bfloat16)
    if int8:
        k, v = quantize(k, axis=-1), quantize(v, axis=-1)
    perm = torch.randperm(pages, generator=g, device=dev)[:b * mp]
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, table, lens


CASES = [
    # b, h, kv, d, ps, mp, kv_len, int8
    (8, 32, 8, 128, 64, 32, (1, 63, 64, 65, 700, 2047, 1500, 333), False),
    (8, 32, 8, 128, 64, 32, (1, 63, 64, 65, 700, 2047, 1500, 333), True),
    (8, 32, 8, 128, 128, 16, (2048, 5, 129, 1000, 0, 77, 1024, 9), False),
    (8, 32, 8, 128, 128, 16, (2048, 5, 129, 1000, 0, 77, 1024, 9), True),
    (3, 8, 8, 64, 16, 5, (80, 3, 200), False),             # group 1, past MP*ps
    (2, 16, 2, 256, 1, 40, (40, 17), True),                # group 8, ps 1
    (4, 12, 6, 128, 7, 9, (63, 1, 30, 62), False),         # odd page size
    (1, 4, 1, 64, 128, 2, (129,), True),
]


@pytest.mark.parametrize("b,h,kv,d,ps,mp,kv_len,int8", CASES)
def test_kernel_matches_plain_version(dev, b, h, kv, d, ps, mp, kv_len,
                                      int8):
    q, k, v, table, lens = _case(dev, b, h, kv, d, ps, mp, kv_len, int8)
    before = fd.flash_decode_paged.launches
    got = fd.flash_decode_paged(q, k, v, table, lens)
    torch.cuda.synchronize()
    assert fd.flash_decode_paged.launches == before + 1
    want = fd.flash_decode_paged_reference(q, k, v, table, lens)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=ATOL)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert bool((got[i] == 0).all())


def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v, table, lens = _case(dev, 2, 8, 2, 128, 16, 4, (5, 9), False)
    with pytest.raises(TypeError):
        fd.flash_decode_paged(q.float(), k, v, table, lens)
    with pytest.raises(ValueError):
        fd.flash_decode_paged(q, k, v, table.t().contiguous().t(), lens)
    with pytest.raises(ValueError):
        fd.flash_decode_paged(q, k, v, table, lens.cpu())
    bad_d = torch.zeros((2, 1, 8, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fd.flash_decode_paged(bad_d, k, v, table, lens)


def _cfg(**kw):
    # head_dim 64: inside the kernel's gate
    return llama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  n_layers=2, max_seq=128, **kw)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_kernel_matches_dense(dev, kv_quant):
    cfg = _cfg(kv_quant=kv_quant)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pool = llama.init_page_pool(cfg, 9, 16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for side in ("k", "v"):
        raw = torch.randn((cfg.n_layers, 9, 16, cfg.n_kv_heads,
                           cfg.head_dim), generator=g, device=dev)
        if kv_quant:
            qt = quantize(raw, axis=-1)
            pool[side] = QTensor(qt.q.contiguous(), qt.s.contiguous())
        else:
            pool[side] = raw.to(torch.bfloat16)
    table = torch.tensor([[0, 1, 2, 3], [4, 5, 8, 8], [6, 7, 8, 8]],
                         dtype=torch.int32, device=dev)
    lengths = torch.tensor([50, 20, 3], dtype=torch.int32, device=dev)
    tokens = torch.tensor([5, 6, 7], dtype=torch.int32, device=dev)
    out = {}
    for mode in ("auto", "dense"):
        p = {s: (QTensor(x.q.clone(), x.s.clone())
                 if isinstance(x, QTensor) else x.clone())
             for s, x in pool.items()}
        out[mode], _ = llama.decode_step_paged(
            dataclasses.replace(cfg, decode_attn=mode), params, p, table,
            lengths, tokens)
    # bf16 rounding flips in attention, carried through 2 layers
    torch.testing.assert_close(out["auto"], out["dense"], rtol=0,
                               atol=5e-2)


def test_auto_on_cuda_refuses_shapes_outside_the_gate(dev):
    cfg = llama.LlamaConfig.tiny(n_layers=1, max_seq=32)   # head_dim 8
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pool = llama.init_page_pool(cfg, 3, 16, device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="decode_attn"):
        llama.decode_step_paged(cfg, params, pool, table, one, one)


def test_paged_server_runs_through_the_kernel(dev):
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(0, cfg.vocab_size, 40)]
    reqs = [{"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
             "max_new": m, "request_id": i}
            for i, (n, m) in enumerate([(8, 6), (33, 9), (90, 20)])]
    reqs.append({"prompt": base, "max_new": 5, "request_id": "a"})
    srv = serving.PagedServer(cfg, params, slots=2, page_size=16,
                              prefill_chunk=16, device=dev)
    before = fd.flash_decode_paged.launches
    srv.drain(reqs, decode_window=4)
    # "a" has retired into the radix: "b" shares its two full pages
    reqs.append({"prompt": base[:36] + [1, 2], "max_new": 5,
                 "request_id": "b"})
    got = srv.drain(reqs[-1:], decode_window=1)
    assert fd.flash_decode_paged.launches > before
    assert {k: len(t) for k, t in got.items()} == {
        r["request_id"]: r["max_new"] for r in reqs}
    assert srv.ledger_violations() == []
    assert srv.page_stats()["prefix_hits"] >= 1


# ---------------------------------------------------------------------------
# slot-cache flash-decode: kernel 2


def _slot_case(dev, b, h, kv, d, s, int8, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=g, device=dev).to(torch.bfloat16)
    if int8:
        k, v = quantize(k, axis=-1), quantize(v, axis=-1)
    return q, k, v


SLOT_CASES = [
    # b, h, kv, d, s, kv_len, int8
    (8, 32, 8, 128, 2048, (1, 63, 64, 65, 700, 2047, 1500, 333), False),
    (8, 32, 8, 128, 2048, (1, 63, 64, 65, 700, 2047, 1500, 333), True),
    (8, 32, 8, 128, 2048, (2048, 0, 5000, 129, 1, 77, 1024, 9), True),
    (3, 8, 8, 64, 100, (100, 0, 37), False),             # group 1, ragged S
    (2, 16, 2, 256, 300, (301, 17), True),               # group 8, past S
    (4, 12, 6, 128, 7, (3, 7, 1, 0), False),             # tiny cache
    (2, 4, 1, 64, 1000, 513, False),                     # a scalar kv_len
]


@pytest.mark.parametrize("b,h,kv,d,s,kv_len,int8", SLOT_CASES)
def test_slot_kernel_matches_plain_version(dev, b, h, kv, d, s, kv_len,
                                           int8):
    q, k, v = _slot_case(dev, b, h, kv, d, s, int8)
    lens = (kv_len if isinstance(kv_len, int) else
            torch.tensor(kv_len, dtype=torch.int32, device=dev))
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_reference(q, k, v, lens)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=ATOL)
    per_row = [kv_len] * b if isinstance(kv_len, int) else kv_len
    for i, n in enumerate(per_row):
        if n == 0:
            assert bool((got[i] == 0).all())


def test_slot_kernel_reads_a_layer_of_the_cache_in_place(dev):
    """A layer view of the [L, B, S, KV, D] cache goes in as it is, and
    rows past kv_len are never read: NaN there changes nothing."""
    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                 n_layers=2, max_seq=96, kv_quant=True)
    cache = llama.init_kv_cache(cfg, 3, cfg.max_seq, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    raw = torch.randn(cache["k"].q.shape, generator=g, device=dev)
    qt = quantize(raw, axis=-1)
    cache["k"].q.copy_(qt.q)
    cache["k"].s.copy_(qt.s)
    cache["v"].q.copy_(qt.q.flip(0))
    cache["v"].s.copy_(qt.s.flip(0))
    lens = torch.tensor([40, 96, 3], dtype=torch.int32, device=dev)
    q = torch.randn((3, 1, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    want = fd.flash_decode_reference(q, cache["k"][1], cache["v"][1], lens)
    cache["k"].s[1, 0, 40:] = float("nan")
    cache["v"].s[1, 2, 3:] = float("nan")
    got = fd.flash_decode(q, cache["k"][1], cache["v"][1], lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=ATOL)


def test_slot_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _slot_case(dev, 2, 8, 2, 128, 64, False)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fd.flash_decode(q.float(), k, v, lens)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, v, lens.long())
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v, lens.cpu())
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        v, lens)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k[:1], v[:1], lens)
    bad_d = torch.zeros((2, 1, 8, 96), dtype=torch.bfloat16, device=dev)
    bad_kv = torch.zeros((2, 64, 2, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fd.flash_decode(bad_d, bad_kv, bad_kv, lens)
    q18 = torch.zeros((2, 1, 18, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fd.flash_decode(q18, k, v, lens)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_slots_kernel_matches_dense(dev, kv_quant):
    cfg = _cfg(kv_quant=kv_quant)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 50)).astype(np.int32)).to(dev)
    lengths = torch.tensor([50, 20, 3], dtype=torch.int32, device=dev)
    tokens = torch.tensor([5, 6, 7], dtype=torch.int32, device=dev)
    cache = llama.init_kv_cache(cfg, 3, cfg.max_seq, device=dev)
    _, cache = llama.prefill(cfg, params, cache, prompt)
    out = {}
    for mode in ("auto", "dense"):
        c = {side: (QTensor(x.q.clone(), x.s.clone())
                    if isinstance(x, QTensor) else x.clone())
             for side, x in cache.items()}
        out[mode], _ = llama.decode_step_slots(
            dataclasses.replace(cfg, decode_attn=mode), params, c, lengths,
            tokens)
    torch.testing.assert_close(out["auto"], out["dense"], rtol=0,
                               atol=5e-2)


def test_slot_server_runs_through_the_kernels(dev):
    """``SlotServer.step`` launches the slot kernel once a layer, and
    bucketed prefill launches the flash-attention forward."""
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    reqs = [{"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
             "max_new": m, "request_id": i}
            for i, (n, m) in enumerate([(8, 6), (33, 9), (90, 20)])]
    srv = serving.SlotServer(cfg, params, slots=2, device=dev)
    n_fwd = fa.flash_attention_fwd.launches
    srv.submit_many([dict(r) for r in reqs[:2]])
    assert fa.flash_attention_fwd.launches == n_fwd + cfg.n_layers
    before = fd.flash_decode.launches
    srv.step()
    assert fd.flash_decode.launches == before + cfg.n_layers
    got = srv.drain([dict(r) for r in reqs[2:]], decode_window=4)
    assert {k: len(t) for k, t in got.items()} == {
        r["request_id"]: r["max_new"] for r in reqs}
    solo = llama.generate_chunked(
        cfg, params, torch.tensor([reqs[0]["prompt"]], device=dev), 6,
        chunk=4)
    assert solo.shape == (1, 6)


# ---------------------------------------------------------------------------
# flash attention: kernels 3 (forward), 4 (dK/dV) and 5 (dQ)

# Both sides accumulate in fp32 and round each output once to bf16, but
# the kernels round P (and dS) to bf16 before their products, as the TPU
# kernel does, and the plain version keeps them fp32: an output may flip
# its last bf16 bits, and the error scales with the largest magnitude.
# rtol 2e-2 plus 1e-2 of max|want|, over each row of a head for O (under
# a causal mask an early row's |o| is near 4, a late one's near 0.04, so
# one scale for the tensor would let a late row go unchecked) and over
# the tensor for a gradient (a row can cancel to 0: dQ of a row that
# sees only its own key); lse (fp32 on both sides) within 1e-3.
FA_RTOL, FA_SCALED_ATOL, LSE_ATOL = 2e-2, 1e-2, 1e-3

FA_CASES = [
    # b, sq, sk, h, kv, d, causal, q_offset
    (16, 511, 511, 12, 6, 128, True, 0),       # the Llama-400m train step
    (2, 2048, 2048, 32, 8, 128, True, 0),      # Llama-3-8B heads
    (3, 77, 200, 4, 1, 64, True, 123),         # ragged, rectangular
    (2, 100, 100, 4, 2, 128, True, -37),       # rows with no live key
    (1, 130, 70, 2, 2, 256, False, 0),         # head_dim 256, full
    # the forward's 128-row q tile and K/V ring: one query row, Sq around
    # the tile against ragged Sk, a causal offset off the tile grid,
    # head_dim 64 and 256 causal, and enough (B, H) blocks for many waves
    (2, 1, 300, 8, 2, 128, True, 299),
    (2, 1, 64, 4, 4, 64, False, 0),
    (1, 129, 127, 4, 2, 128, True, -2),
    (1, 129, 129, 4, 2, 128, True, 0),
    (1, 129, 257, 4, 2, 128, True, 128),
    (2, 300, 500, 8, 4, 128, True, 77),
    (2, 300, 300, 8, 2, 64, True, 0),
    (2, 300, 300, 4, 4, 256, True, 0),
    (8, 2048, 2048, 32, 8, 128, True, 0),      # the slot-prefill bucket
    # the backward's tiles (dQ: 128 q rows, 64-key stages; dK/dV: 128 keys,
    # 64-row q stages over the GQA group): a group of 4 with ragged Sk, Sk
    # one past a key tile against one q tile, and enough (KV, B) key tiles
    # for several rounds of the persistent grid
    (1, 257, 385, 8, 2, 128, True, 128),
    (1, 64, 129, 4, 2, 128, False, 0),
    (8, 1024, 1024, 16, 4, 128, True, 0),
]


def _fa_case(dev, b, sq, sk, h, kv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    return r(b, sq, h, d), r(b, sk, kv, d), r(b, sk, kv, d), r(b, sq, h, d)


def _fa_close(got, want, rows=True):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = w.abs().amax(dim=-1, keepdim=True) if rows else w.abs().max()
    tol = FA_SCALED_ATOL * scale + FA_RTOL * w.abs()
    assert bool(torch.isfinite(g).all())
    assert not bool((err > tol).any()), (
        f"{int((err > tol).sum())} elements off, max abs err "
        f"{float(err.max()):.3e}, worst error "
        f"{float((err / tol.clamp_min(1e-30)).max()):.3g} x its limit")


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,off", FA_CASES)
def test_flash_attention_kernels_match_plain_versions(dev, b, sq, sk, h, kv,
                                                      d, causal, off):
    q, k, v, do = _fa_case(dev, b, sq, sk, h, kv, d)
    kw = dict(causal=causal, q_offset=off)
    n0 = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkdv.launches,
          fa.flash_attention_bwd_dq.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.shape == (b, h, sq)
    _fa_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=LSE_ATOL)
    delta = fa.attention_delta(o_ref, do)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse_ref, delta, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_attention_bwd_dkdv_reference(
        q, k, v, do, lse_ref, delta, **kw)
    dq_ref = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta,
                                                 **kw)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert bool(torch.isfinite(got.float()).all())
        _fa_close(got, want, rows=False)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dkdv.launches,
            fa.flash_attention_bwd_dq.launches) == tuple(n + 1 for n in n0)
    if off < 0:
        dead = -off
        assert bool((o[:, :dead] == 0).all()) and bool((dq[:, :dead] == 0).all())
        assert bool((lse[:, :, :dead] == -1e30).all())


def test_flash_attention_forward_is_deterministic(dev):
    """50 launches on the same inputs give bitwise-equal O and lse: a K/V
    stage handed back to the producer before its last reader completed
    would show up as run-to-run differences."""
    q, k, v, _ = _fa_case(dev, 16, 511, 511, 12, 6, 128, seed=3)
    o0, lse0 = fa.flash_attention_fwd(q, k, v)
    for _ in range(49):
        o, lse = fa.flash_attention_fwd(q, k, v)
        assert torch.equal(o, o0) and torch.equal(lse, lse0)


@pytest.mark.parametrize("sm_scale", [0.3, 0.0, -0.2])
def test_flash_attention_forward_takes_any_scale(dev, sm_scale):
    """A positive scale folds into the kernel's exponent; zero and
    negative scales take the plain product, as the reference allows."""
    q, k, v, _ = _fa_case(dev, 2, 200, 300, 8, 2, 128, seed=5)
    kw = dict(causal=True, q_offset=60, sm_scale=sm_scale)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    _fa_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=LSE_ATOL)


def test_flash_attention_backward_is_deterministic(dev):
    """50 launches of each backward kernel on the same inputs give
    bitwise-equal dq, dk and dv: a Q/dO or K/V stage handed back to the
    producer before its last reader completed, or a sum whose order
    changes between runs, would show up here."""
    q, k, v, do = _fa_case(dev, 16, 511, 511, 12, 6, 128, seed=4)
    o, lse = fa.flash_attention_reference(q, k, v)
    args = (q, k, v, do, lse, fa.attention_delta(o, do))
    dq0 = fa.flash_attention_bwd_dq(*args)
    dk0, dv0 = fa.flash_attention_bwd_dkdv(*args)
    for _ in range(49):
        assert torch.equal(fa.flash_attention_bwd_dq(*args), dq0)
        dk, dv = fa.flash_attention_bwd_dkdv(*args)
        assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


@pytest.mark.parametrize("sm_scale", [0.3, 0.0, -0.2])
def test_flash_attention_backward_takes_any_scale(dev, sm_scale):
    """The backward kernels at any softmax scale, zero and negative too,
    against their plain versions from the plain forward's lse."""
    q, k, v, do = _fa_case(dev, 2, 200, 300, 8, 2, 128, seed=5)
    kw = dict(causal=True, q_offset=60, sm_scale=sm_scale)
    o, lse = fa.flash_attention_reference(q, k, v, **kw)
    args = (q, k, v, do, lse, fa.attention_delta(o, do))
    dk, dv = fa.flash_attention_bwd_dkdv(*args, **kw)
    dq = fa.flash_attention_bwd_dq(*args, **kw)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_attention_bwd_dkdv_reference(*args, **kw)
    dq_ref = fa.flash_attention_bwd_dq_reference(*args, **kw)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _fa_close(got, want, rows=False)


def test_flash_attention_autograd_matches_dense_on_card(dev):
    from dcos_commons_tpu_torch.ops.attention import gqa_attention
    q, k, v, do = _fa_case(dev, 2, 300, 300, 8, 2, 128, seed=1)
    grads = {}
    for name, fn in (("flash", fa.flash_attention), ("dense", gqa_attention)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do)
        grads[name] = [out.detach()] + [t.grad for t in leaves]
    _fa_close(grads["flash"][0], grads["dense"][0])
    for got, want in zip(grads["flash"][1:], grads["dense"][1:]):
        _fa_close(got, want, rows=False)


def test_flash_attention_refuses_what_the_kernels_do_not_take(dev):
    q, k, v, _ = _fa_case(dev, 1, 64, 64, 4, 2, 128)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.float(), k.float(), v.float())
    bad = torch.zeros((1, 64, 4, 96), dtype=torch.bfloat16, device=dev)
    bad_kv = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(bad, bad_kv, bad_kv)
    q6 = torch.zeros((1, 64, 6, 128), dtype=torch.bfloat16, device=dev)
    k4 = torch.zeros((1, 64, 4, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q6, k4, k4)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                                 n_layers=1)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.zeros((1, 9), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        llama.loss_fn(cfg, params, toks)


def _train_cfg(**kw):
    # head_dim 64: inside the kernels' gate
    return llama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  n_layers=2, max_seq=128, **kw)


def test_train_step_runs_through_the_three_kernels(dev):
    cfg = _train_cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = train.make_optimizer(lr=1e-3, warmup=1, decay_steps=100)
    state = train.init_opt_state(opt, params)
    step = train.make_train_step(lambda p, b: llama.loss_fn(cfg, p, b), opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 97)).astype(np.int32)).to(dev)
    n0 = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkdv.launches,
          fa.flash_attention_bwd_dq.launches)
    losses = []
    for _ in range(3):
        params, state, out = step(params, state, toks)
        losses.append(float(out["loss"]))
    assert (fa.flash_attention_fwd.launches - n0[0],
            fa.flash_attention_bwd_dkdv.launches - n0[1],
            fa.flash_attention_bwd_dq.launches - n0[2]) == (6, 6, 6)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.mu["layers"]["wq"].dtype == torch.bfloat16


def test_loss_kernel_matches_dense_on_card(dev):
    cfg = _train_cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 97)).astype(np.int32)).to(dev)
    res = {}
    for mode in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=mode)
        leaves = {k: v.clone().requires_grad_()
                  for k, v in params["layers"].items()}
        p = dict(params, layers=leaves)
        loss, _ = llama.loss_fn(c, p, toks)
        loss.backward()
        res[mode] = (float(loss.detach()),
                     {k: v.grad.float() for k, v in leaves.items()})
    assert abs(res["flash"][0] - res["dense"][0]) < 1e-2
    for name, g in res["flash"][1].items():
        want = res["dense"][1][name]
        rel = float((g - want).norm() / want.norm().clamp_min(1e-30))
        assert rel < 5e-2, (name, rel)
