"""Port tests that need the card: the paged flash-decode CUDA kernel
against its plain PyTorch version across shapes, page sizes and int8
pages, and the paged engine running through it.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from dcos_commons_tpu_torch.models import llama, serving
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
