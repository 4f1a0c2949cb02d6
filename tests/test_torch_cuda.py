"""Port tests that need the card: the paged flash-decode CUDA kernel
against its plain PyTorch version across shapes, page sizes and int8
pages, and the paged engine running through it; the flash-attention
forward, dK/dV and dQ kernels against their plain versions (the smoke
run's two shapes, a ragged and a negative-offset case, head_dim 256),
their refusals, and the train step running through them.

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
# flash attention: kernels 3 (forward), 4 (dK/dV) and 5 (dQ)

# Both sides accumulate in fp32 and round each output once to bf16, but
# the kernels round P (and dS) to bf16 before their products, as the TPU
# kernel does, and the plain version keeps them fp32: an output may flip
# its last bf16 bits, and the error scales with the tensor's largest
# magnitude. rtol 2e-2 plus 1e-2 of max|want|; lse (fp32 on both sides)
# within 1e-3.
FA_RTOL, FA_SCALED_ATOL, LSE_ATOL = 2e-2, 1e-2, 1e-3

FA_CASES = [
    # b, sq, sk, h, kv, d, causal, q_offset
    (16, 511, 511, 12, 6, 128, True, 0),       # the Llama-400m train step
    (2, 2048, 2048, 32, 8, 128, True, 0),      # Llama-3-8B heads
    (3, 77, 200, 4, 1, 64, True, 123),         # ragged, rectangular
    (2, 100, 100, 4, 2, 128, True, -37),       # rows with no live key
    (1, 130, 70, 2, 2, 256, False, 0),         # head_dim 256, full
]


def _fa_case(dev, b, sq, sk, h, kv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    return r(b, sq, h, d), r(b, sk, kv, d), r(b, sk, kv, d), r(b, sq, h, d)


def _fa_close(got, want):
    atol = FA_SCALED_ATOL * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_RTOL,
                               atol=atol)


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
        _fa_close(got, want)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dkdv.launches,
            fa.flash_attention_bwd_dq.launches) == tuple(n + 1 for n in n0)
    if off < 0:
        dead = -off
        assert bool((o[:, :dead] == 0).all()) and bool((dq[:, :dead] == 0).all())
        assert bool((lse[:, :, :dead] == -1e30).all())


def test_flash_attention_autograd_matches_dense_on_card(dev):
    from dcos_commons_tpu_torch.ops.attention import gqa_attention
    q, k, v, do = _fa_case(dev, 2, 300, 300, 8, 2, 128, seed=1)
    grads = {}
    for name, fn in (("flash", fa.flash_attention), ("dense", gqa_attention)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do)
        grads[name] = [out.detach()] + [t.grad for t in leaves]
    for got, want in zip(grads["flash"], grads["dense"]):
        _fa_close(got, want)


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
