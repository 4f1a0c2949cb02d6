"""Port tests that need the card: the paged flash-decode CUDA kernel
against its plain PyTorch version across shapes, page sizes 1-256 and
int8 pages, and the paged engine running through it; the slot-cache
flash-decode kernel against its plain version (int8, kv_len 0, 1 and past
the cache, lengths off the 64-position stage, head_dim 64/128/256, groups
1-8), its refusals, and ``SlotServer`` and solo decode running through
it; for both decode kernels, a second call on other inputs (a counter
left set), 20 bitwise-equal launches, a CUDA-graph replay equal to eager,
and one device kernel per warm call with no workspace allocation; the
flash-attention
forward, dK/dV and dQ kernels against their plain versions (the smoke
run's shapes, ragged and negative-offset cases, one query row, Sq
around the forward's 128-row tile, head_dim 64 and 256, the B=8
slot-prefill bucket, and the edges of the backward's tiles), the run-to-
run determinism and any softmax scale of the forward and of the
backward, their refusals, and the train step running through them;
the model's attention routed by the kernels' gate (head_dim 8 dense,
128 through the kernels); the fused linear-KL head at the Llama-3 vocab
against the materialized KL; one distill step at Llama-3-8B width
through kernels 3-5 with the teacher left bit-identical;
the MoE paged engine's decode windows as CUDA graphs (bitwise equal to
the eager loop for top-2 dropless and capacity-bounded and for expert
choice, kernel 1 launched once a layer a step inside them) and
``moe_apply_local`` on the card against the CPU in fp32;
the paged engine's speculative window as a CUDA graph (graphed windows
bitwise equal to the eager loop for k 2 and 4, bf16 and int8-KV pools, a
widening table; ``reset`` and disarm keeping the graphs valid; k draft
launches of the slot kernel a window), the verify against successive
kernel decode steps, and the batch-1 ``SpeculativeDecoder`` through the
kernels.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dcos_commons_tpu_torch.frameworks import worker
from dcos_commons_tpu_torch.models import llama, serving, speculative, train
from dcos_commons_tpu_torch.ops import losses
from dcos_commons_tpu_torch.ops import flash_attention as fa
from dcos_commons_tpu_torch.ops import flash_decode as fd
from dcos_commons_tpu_torch.ops.quant import QTensor, quantize
from dcos_commons_tpu_torch.parallel.moe import (MoEConfig, dropless,
                                                 moe_apply_local)

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
    # page sizes 1-256, groups 1-8, head_dim 64-256; lengths off the
    # 64-position stage, 0, 1 and past the table; long streams whose
    # chunks are lengthened to keep 16 partials
    (4, 16, 8, 128, 256, 4, (1024, 0, 1, 777), True),          # group 2
    (3, 32, 4, 64, 16, 70, (1120, 1119, 5000), False),         # group 8
    (2, 8, 2, 256, 64, 40, (2560, 1337), False),               # 8, 7 chunks
    (5, 8, 4, 128, 1, 300, (300, 299, 1, 0, 150), True),       # ps 1
    (2, 16, 16, 128, 32, 8, (256, 100), False),                # group 1
    (2, 32, 8, 128, 64, 128, (8192, 5000), False),             # S 8192
    (3, 16, 4, 256, 16, 9, (144, 143, 17), True),              # D 256 int8
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
    (3, 16, 8, 128, 4000, (4000, 3999, 1), False),       # group 2, long
    (2, 8, 1, 64, 130, (129, 130), True),                # group 8, D 64
    (3, 8, 2, 256, 2100, (2100, 65, 0), True),           # D 256 int8
    (1, 4, 4, 128, 8192, (8192,), False),                # group 1, S 8192
    (4, 32, 8, 128, 2048, (2048, 2047, 64, 63), False),  # 8 partials a head
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
    # the first window also runs once eagerly before its graph is
    # captured; a warm window launches the kernel once a layer
    srv.step()
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
# both decode kernels: one launch a call, a workspace kept between calls


def _decode_call(dev, kind, seed, lens=(1, 63, 64, 65, 700, 2047, 1500,
                                        333), int8=False):
    """(call, plain) of one decode kernel on the 8B decode shape: ``call()``
    runs the wrapper, ``plain()`` the plain version, on inputs from
    ``seed``; ``inputs`` are the tensors a graph replay reads."""
    if kind == "paged":
        q, k, v, table, kv = _case(dev, 8, 32, 8, 128, 64, 32, lens, int8,
                                   seed)
        return (lambda: fd.flash_decode_paged(q, k, v, table, kv),
                lambda: fd.flash_decode_paged_reference(q, k, v, table, kv),
                (q, kv))
    q, k, v = _slot_case(dev, 8, 32, 8, 128, 2048, int8, seed)
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    return (lambda: fd.flash_decode(q, k, v, kv),
            lambda: fd.flash_decode_reference(q, k, v, kv), (q, kv))


@pytest.mark.parametrize("kind", ["paged", "slots"])
def test_decode_kernel_second_call_and_twenty_launches(dev, kind):
    """A second call on other lengths, then the first again: a counter left
    set (or a partial read from the wrong call) shows up as a wrong or
    changed output. Then 20 launches are bitwise equal: the last block of
    a pair merges its partials in a fixed order, whichever block it is."""
    first, first_plain, _ = _decode_call(dev, kind, 0)
    other, other_plain, _ = _decode_call(dev, kind, 1,
                                         lens=(2048, 5, 129, 1000, 0, 77,
                                               1024, 9))
    a = first()
    b = other()
    torch.testing.assert_close(b.float(), other_plain().float(), rtol=RTOL,
                               atol=ATOL)
    assert bool((b[4] == 0).all())
    again = first()
    torch.testing.assert_close(a.float(), first_plain().float(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(a, again)
    for _ in range(20):
        assert torch.equal(first(), a)


@pytest.mark.parametrize("kind", ["paged", "slots"])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_replays_in_a_cuda_graph(dev, kind, int8):
    """One call captured in a CUDA graph and replayed twice equals the
    eager call bitwise; after new q and lengths are copied into the
    captured inputs, a replay equals the eager call on them."""
    call, _, (q, kv) = _decode_call(dev, kind, 2, int8=int8)
    eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    q.copy_(torch.randn(q.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9)))
    kv.copy_(kv.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, call())


@pytest.mark.parametrize("kind", ["paged", "slots"])
def test_decode_kernel_is_one_launch_a_call(dev, kind):
    """A warm call runs exactly one device kernel (no combine pass, no
    broadcast of the lengths, no scratch) and allocates only its output;
    the kept workspace stays the same tensors."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    call, _, _ = _decode_call(dev, kind, 3)
    call()
    torch.cuda.synchronize()
    kept = {k: (a.data_ptr(), c.data_ptr())
            for k, (a, c) in fd._WORKSPACE.items()}
    calls = 3
    # one step of warm-up inside the profiler: its first events of a
    # session can be lost while the device tracing starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        allocs = (torch.cuda.memory_stats()["allocation.all.allocated"]
                  - allocs)
        prof.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    assert len(kernels) == calls, [e.name for e in kernels]
    assert all("decode_kernel" in e.name for e in kernels)
    assert allocs == calls
    assert {k: (a.data_ptr(), c.data_ptr())
            for k, (a, c) in fd._WORKSPACE.items()} == kept


def test_decode_kernel_takes_kv_len_in_every_form(dev):
    """kv_len as an int, a [1] and a [B] int32 tensor give the same
    output, with no copy kernel before the launch."""
    q, k, v = _slot_case(dev, 4, 16, 4, 128, 700, False, seed=4)
    want = fd.flash_decode(q, k, v, torch.full((4,), 650, dtype=torch.int32,
                                                device=dev))
    for form in (650, torch.tensor([650], dtype=torch.int32, device=dev)):
        assert torch.equal(fd.flash_decode(q, k, v, form), want)


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


FA_COUNTERS = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
               fa.flash_attention_bwd_dq)


def _fa_launches():
    return tuple(c.launches for c in FA_COUNTERS)


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("dim,heads,kv,want", [
    (64, 8, 4, (2, 2, 2)),        # head_dim 8, zero-padded to 64
    (256, 2, 1, (2, 2, 2)),       # head_dim 128
    (1024, 2, 1, (0, 0, 0)),      # head_dim 512: dense, as the reference
])
def test_train_attention_routes_on_the_card(dev, impl, dim, heads, kv, want):
    """A train step of a 2-layer model at S=64 through ``auto`` and
    ``flash``: one launch of each kernel a layer up to head_dim 256
    (llama-train's head_dim 8 padded to the kernels' 64), none beyond;
    the loss and the layer gradients agree with the dense path (within
    1e-2 absolute and 5e-2 relative in norm: bf16 products)."""
    cfg = llama.LlamaConfig.tiny(dim=dim, n_heads=heads, n_kv_heads=kv,
                                 n_layers=2, attn_impl=impl)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)).to(dev)
    res = {}
    for mode in (impl, "dense"):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in params["layers"].items()}
        n0 = _fa_launches()
        loss, _ = llama.loss_fn(dataclasses.replace(cfg, attn_impl=mode),
                                dict(params, layers=leaves), toks)
        loss.backward()
        res[mode] = (float(loss.detach()),
                     {k: v.grad.float() for k, v in leaves.items()},
                     tuple(a - b for a, b in zip(_fa_launches(), n0)))
    assert res[impl][2] == want and res["dense"][2] == (0, 0, 0)
    assert np.isfinite(res[impl][0])
    assert abs(res[impl][0] - res["dense"][0]) < 1e-2
    for name, g in res[impl][1].items():
        want_g = res["dense"][1][name]
        rel = float((g - want_g).norm() / want_g.norm().clamp_min(1e-30))
        assert rel < 5e-2, (name, rel)


@pytest.mark.parametrize("attn,want", [("auto", (0, 0, 0)),
                                       ("flash", (16, 16, 16))])
def test_llama_train_worker_attention_on_the_card(dev, attn, want,
                                                  capsys):
    """``llama-train --seq 256 --steps 3`` on the card: ``--attn auto``
    trains dense, as the reference's ``auto`` under its train mesh;
    ``--attn flash`` runs kernels 3-5 at the tiny config's head_dim 8,
    one launch a layer a step (4 layers, the warm-up and 3 steps)."""
    n0 = _fa_launches()
    assert worker.main(["llama-train", "--attn", attn, "--seq", "256",
                        "--steps", "3", "--device", "cuda"]) == 0
    done = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")][-1]
    assert done["event"] == "done" and done["attn"] == attn
    assert np.isfinite(done["final_loss"])
    assert tuple(a - b for a, b in zip(_fa_launches(), n0)) == want


def test_fused_kl_head_at_the_llama3_vocab(dev):
    """The fused head against the materialized KL at B=2, S=256,
    D=4096, V=128256 in bf16: the same loss within 1e-4 relative (both
    reduce the same bf16 logits in fp32), the student gradients within
    2e-2 relative in norm (both round dlogits to bf16 for the products),
    and nothing for the teacher."""
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, d, v = 2, 256, 4096, 128256

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    x_s, x_t = rand(b, s, d), rand(b, s, d)
    w_s, w_t = rand(d, v, scale=d ** -0.5), rand(d, v, scale=d ** -0.5)
    mask = torch.rand((b, s), generator=g, device=dev) > 0.2
    res = {}
    for name in ("fused", "plain"):
        xs, ws = x_s.clone().requires_grad_(), w_s.clone().requires_grad_()
        if name == "fused":
            loss = losses.fused_linear_distillation(
                xs, ws, x_t, w_t, mask=mask, temperature=2.0)
        else:
            loss = losses.softmax_kl_divergence(
                xs @ ws, x_t @ w_t, mask=mask, temperature=2.0)
        loss.backward()
        res[name] = (float(loss.detach()), xs.grad.float(), ws.grad.float())
    assert res["fused"][0] == pytest.approx(res["plain"][0], rel=1e-4)
    for got, want in zip(res["fused"][1:], res["plain"][1:]):
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert rel < 2e-2, rel


def test_distill_step_at_8b_width_runs_kernels_3_to_5(dev):
    """Three steps of the worker's distill loss on a 2-layer
    Llama-3-8B-width teacher (B=2, S=256): kernels 3-5 launch (3 forward
    launches a loss, teacher and student; 1 of each backward kernel), the
    loss is finite and falls at a rate small against Adam's first,
    sign-like steps (at the workload's 2e-4 the second step's update
    raised the loss), and the teacher is bit-identical."""
    cfg_t = llama.LlamaConfig.llama3_8b(n_layers=2, max_seq=512, remat=False)
    params_t = llama.init_params(
        cfg_t, torch.Generator(device=dev).manual_seed(0), device=dev)
    frozen = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  {n: w.clone() for n, w in v.items()})
              for k, v in params_t.items()}
    cfg_d, params_d = speculative.draft_student(cfg_t, params_t, 1)
    opt = train.make_optimizer(lr=1e-5, warmup=1, decay_steps=100)
    state = train.init_opt_state(opt, params_d)
    step = train.make_train_step(
        speculative.distill_loss(cfg_t, params_t, cfg_d, 1.0), opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg_t.vocab_size, (2, 256)).astype(np.int32)).to(dev)
    n0 = _fa_launches()
    losses_ = []
    for _ in range(3):
        params_d, state, out = step(params_d, state, toks)
        losses_.append(float(out["loss"]))
    assert tuple(a - b for a, b in zip(_fa_launches(), n0)) == (9, 3, 3)
    assert all(np.isfinite(losses_)) and losses_[-1] < losses_[0], losses_
    for k, v in frozen.items():
        for n, w in (v.items() if isinstance(v, dict) else [(k, v)]):
            now = params_t[k][n] if isinstance(v, dict) else params_t[k]
            assert torch.equal(now, w), (k, n)


# ---------------------------------------------------------------------------
# the engines' decode windows as CUDA graphs


def _engine(kind, cfg, params, dev, **kw):
    if kind == "paged":
        return serving.PagedServer(cfg, params, slots=4, page_size=16,
                                   prefill_chunk=16, device=dev, **kw)
    return serving.SlotServer(cfg, params, slots=4, device=dev, **kw)


def _live(srv, cfg, seed=0, lens=(3, 15, 40, 70), max_new=40):
    """Four streams prefilled and decoding (lengths that cross 16-position
    pages within a few windows)."""
    rng = np.random.default_rng(seed)
    srv.submit_many([
        {"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
         "max_new": max_new, "request_id": i} for i, n in enumerate(lens)])
    while getattr(srv, "_prefill_q", None) or srv._pending_first:
        srv.step()
    assert len(srv._active()) == len(lens)


def _kv_clone(kv):
    return {s: (QTensor(x.q.clone(), x.s.clone()) if isinstance(x, QTensor)
                else x.clone()) for s, x in kv.items()}


def _kv_equal(a, b):
    for s in ("k", "v"):
        x, y = a[s], b[s]
        if isinstance(x, QTensor):
            if not (torch.equal(x.q, y.q) and torch.equal(x.s, y.s)):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def _eager_windows(srv, kv, windows, k, generator=None):
    """The eager model-function loop by hand, from a snapshot of ``srv``
    (its kv, lengths and tokens cloned): ``windows`` windows of ``k``
    decode steps over the active streams, the paged table rebuilt per
    window at the width the engine would use. Returns (tokens [windows *
    k, slots], lengths, tokens)."""
    active = srv._active()
    mask = torch.zeros((srv.slots,), dtype=torch.bool, device=srv.device)
    mask[active] = True
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    out = []
    for _ in range(windows):
        if isinstance(srv, serving.PagedServer):
            top = int(ln.max()) + 1
            mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
            tbl = torch.tensor(srv._decode_tables()[:, :mp],
                               device=srv.device)
        for _ in range(k):
            if isinstance(srv, serving.PagedServer):
                logits, _ = llama.decode_step_paged(
                    srv.cfg, srv.params, kv, tbl, ln, tok, rope=srv._rope,
                    ffn_override=srv._ffn)
            else:
                logits, _ = llama.decode_step_slots(
                    srv.cfg, srv.params, kv, ln, tok, rope=srv._rope)
            nxt = torch.where(mask, llama._select(
                srv.sampler, generator, logits, torch.int32), tok)
            ln = torch.where(mask, ln + 1, ln)
            tok = nxt
            out.append(nxt)
    return torch.stack(out), ln, tok


def _graphed_windows(srv, windows, k):
    active = srv._active()
    got = {i: [] for i in active}
    for _ in range(windows):
        for i, toks in srv.step_many(k).items():
            got[i] += toks
    return got


GRAPH_CASES = [
    # engine, kv_quant, int8 weights, sampled, k
    ("paged", False, False, False, 1), ("paged", False, False, False, 8),
    ("paged", True, False, False, 1), ("paged", True, False, False, 8),
    ("slots", False, False, False, 1), ("slots", False, False, False, 8),
    ("slots", True, False, False, 1), ("slots", True, False, False, 8),
    ("paged", False, True, False, 8), ("slots", True, True, False, 8),
    ("paged", False, False, True, 8), ("slots", False, False, True, 1),
]


@pytest.mark.parametrize("kind,kv_quant,qweights,sampled,k", GRAPH_CASES)
def test_graphed_windows_equal_the_eager_loop(dev, kind, kv_quant, qweights,
                                              sampled, k):
    """From one snapshot, the engine's graphed windows and the eager loop
    by hand give the same tokens and lengths, and write the same K/V
    bitwise; the paged table widens between windows; a sampled engine
    draws the eager loop's stream from the same generator state."""
    from dcos_commons_tpu_torch.ops.sampling import make_sampler
    cfg = _cfg(kv_quant=kv_quant)
    if qweights:
        params = llama.init_quantized_params(
            cfg, torch.Generator().manual_seed(0), device=dev)
    else:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    kw = {}
    if sampled:
        kw = dict(sampler=make_sampler(0.9, top_k=50),
                  generator=torch.Generator(device=dev).manual_seed(3))
    srv = _engine(kind, cfg, params, dev, **kw)
    _live(srv, cfg)
    windows = 24 // k
    kv = _kv_clone(srv.pool if kind == "paged" else srv.cache)
    gen = None
    if sampled:
        gen = torch.Generator(device=dev)
        gen.set_state(srv.generator.get_state())
    want, ln, tok = _eager_windows(srv, kv, windows, k, gen)
    got = _graphed_windows(srv, windows, k)
    assert srv.graph_stats()["graphs"] >= 1
    if kind == "paged":
        widths = {key[1] for key in srv._graphs}
        assert len(widths) >= 2, widths
    for i, toks in got.items():
        assert toks == want[:, i].tolist(), i
    assert torch.equal(srv.lengths, ln) and torch.equal(srv.cur_tok, tok)
    assert _kv_equal(srv.pool if kind == "paged" else srv.cache, kv)
    if sampled:
        # the generator advanced as the eager loop's did
        assert torch.equal(srv.generator.get_state(), gen.get_state())


@pytest.mark.parametrize("kind", ["paged", "slots"])
def test_reset_keeps_the_graphs_valid(dev, kind):
    """Windows capture graphs; after ``reset`` the same graphs replay on
    the zeroed state and give a fresh engine's tokens."""
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(5)
    reqs = [{"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
             "max_new": m, "request_id": i}
            for i, (n, m) in enumerate([(9, 20), (30, 25), (4, 30)])]
    srv = _engine(kind, cfg, params, dev)
    srv.drain([dict(r) for r in reqs], decode_window=8)
    graphs = dict(srv._graphs)
    srv.submit_many([dict(r) for r in reqs[:2]])
    srv.step_many(8)
    srv.reset()
    got = srv.drain([dict(r) for r in reqs], decode_window=8)
    assert all(srv._graphs[key] is g for key, g in graphs.items())
    fresh = _engine(kind, cfg, params, dev).drain(
        [dict(r) for r in reqs], decode_window=8)
    assert got == fresh


def test_a_grown_workspace_keeps_a_captured_graph_valid(dev):
    """Capture the paged kernel at a small table width (several chunks a
    stream, so the partials and counters are used), grow the stream's
    workspace with a wide call, then allocate on that stream what the
    growth would have freed and fill it with junk: the small graph's
    replay still equals its eager call."""
    q, k, v, table, kv = _case(dev, 8, 32, 8, 128, 64, 32,
                               (1, 63, 64, 65, 700, 2047, 1500, 333), False)
    small = table[:, :4].contiguous()
    small_kv = kv.clamp(max=256).contiguous()
    stream = torch.cuda.Stream()
    key = (q.device.index, stream.cuda_stream)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = fd.flash_decode_paged(q, k, v, small, small_kv)
        part, counters = fd._WORKSPACE[key]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = fd.flash_decode_paged(q, k, v, small, small_kv)
        wide = fd.flash_decode_paged(q, k, v, table, kv)
        assert fd._WORKSPACE[key][0].numel() > part.numel()
        sizes = (part.numel(), counters.numel())
        del part, counters
        junk = [torch.full((sizes[0],), float("nan"), device=dev)
                for _ in range(4)]
        junk += [torch.full((sizes[1],), 7, dtype=torch.int32, device=dev)
                 for _ in range(4)]
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, want)
    torch.testing.assert_close(wide.float(), fd.flash_decode_paged_reference(
        q, k, v, table, kv).float(), rtol=RTOL, atol=ATOL)
    del junk


def test_paged_warmup_then_a_wider_window_then_width_one(dev):
    """The worker's order: ``warmup`` captures the width-1 window, longer
    streams then grow the workspace, and a later width-1 window replays
    the first graph: its tokens equal a fresh engine's."""
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    srv = _engine("paged", cfg, params, dev)
    timings = srv.warmup(widths=(1,))
    assert list(timings) == ["chunk", "step_w1"] and (1, 1) in srv._graphs
    rng = np.random.default_rng(2)
    long = [{"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, 90)],
             "max_new": 12, "request_id": "long"}]
    srv.drain(long, decode_window=1)
    short = [{"prompt": [3, 1, 4], "max_new": 6, "request_id": "short"}]
    got = srv.drain(short, decode_window=1)["short"]
    assert got == _engine("paged", cfg, params, dev).drain(
        short, decode_window=1)["short"]


@pytest.mark.parametrize("kind", ["paged", "slots"])
def test_a_warm_window_is_one_graph_launch(dev, kind):
    """A warm graphed window of 8 steps: one ``cudaGraphLaunch`` and no
    ``cudaLaunchKernel``; the replay adds the captured kernel launches to
    the wrapper's count."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    # pages of 64: the table width stays 1 through these windows, so the
    # profiled ones replay the captured graph
    srv = (serving.PagedServer(cfg, params, slots=4, page_size=64,
                               prefill_chunk=16, device=dev)
           if kind == "paged" else _engine(kind, cfg, params, dev))
    _live(srv, cfg, lens=(3, 5, 7, 9))
    srv.step_many(8)                                    # capture
    captured = dict(srv._graphs)
    counter = fd.flash_decode_paged if kind == "paged" else fd.flash_decode
    torch.cuda.synchronize()
    # one window of warm-up inside the profiler: its first events of a
    # session can be lost while the device tracing starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        srv.step_many(8)
        prof.step()
        before = counter.launches
        srv.step_many(8)
        prof.step()
    names = [e.name for e in prof.events()]
    assert srv._graphs == captured
    assert names.count("cudaGraphLaunch") == 1, names
    assert not [n for n in names if n.startswith("cudaLaunchKernel")]
    assert counter.launches - before == 8 * cfg.n_layers


def test_init_quantized_params_puts_no_bf16_weight_on_the_card(dev):
    cfg = llama.LlamaConfig.llama_400m()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_quantized_params(
        cfg, torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base

    def leaves(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from leaves(v)
            elif isinstance(v, QTensor):
                yield v.q
                yield v.s
            else:
                yield v

    held = sum(t.numel() * t.element_size() for t in leaves(params))
    smallest_bf16_stack = 2 * min(
        w.q.numel() for w in params["layers"].values()
        if isinstance(w, QTensor))
    # the allocator rounds each block up to 512 bytes
    assert peak <= held + 512 * 64
    assert peak < held + smallest_bf16_stack
    assert all(t.device.type == "cuda" for t in leaves(params))
    assert params["layers"]["w_gate"].q.dtype == torch.int8


# ---------------------------------------------------------------------------
# speculative decoding: the spec window as a CUDA graph


def _armed(dev, kv_quant=False, layers=1, k=4):
    """A paged engine of the small model armed with its first ``layers``
    layers as the draft (all of them: the self-draft)."""
    cfg = _cfg(kv_quant=kv_quant)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    srv = _engine("paged", cfg, params, dev)
    srv.arm_draft(*llama.truncate_layers(cfg, params, layers), k=k)
    return cfg, params, srv


SPEC_GRAPH_CASES = [(2, False), (4, False), (2, True), (4, True)]


@pytest.mark.parametrize("k,kv_quant", SPEC_GRAPH_CASES)
def test_graphed_spec_windows_equal_the_eager_loop(dev, k, kv_quant):
    """From one snapshot of four decoding streams, the engine's graphed
    spec windows and the eager loop by hand (``chip_smoke.
    spec_eager_loop``, acceptance counted on the host) give the same
    tokens, ``n_emit`` and lengths and write the same live K/V rows in the
    pool and the draft cache, bitwise; the table widens between windows;
    a replayed window launches kernel 2 k times (one draft layer)."""
    import chip_smoke
    cfg, params, srv = _armed(dev, kv_quant, k=k)
    _live(srv, cfg)
    out = chip_smoke._spec_graph_vs_eager(srv, windows=24 // k)
    assert out["kernel2_launches_per_window"]
    widths = {key[2] for key in srv._graphs if key[0] == "spec"}
    assert len(widths) >= 2, widths


def test_reset_keeps_the_spec_graphs_valid(dev):
    """The self-draft serves (capturing its spec graphs), ``reset``
    zeroes the draft cache in place, memory freed since is filled with
    junk, and the same graphs then give a fresh engine's tokens and
    acceptance."""
    cfg, params, srv = _armed(dev, layers=2)
    rng = np.random.default_rng(5)
    reqs = [{"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
             "max_new": m, "request_id": i}
            for i, (n, m) in enumerate([(9, 20), (30, 25), (4, 30)])]
    srv.drain([dict(r) for r in reqs], decode_window=8)
    graphs = {key: g for key, g in srv._graphs.items() if key[0] == "spec"}
    assert graphs
    cache = srv._draft_cache["k"]
    srv.reset()
    assert srv._draft_cache["k"] is cache
    size = cache.numel()
    junk = [torch.full((size,), float("nan"), dtype=cache.dtype,
                       device=dev) for _ in range(4)]
    before = dict(srv.page_stats()["spec"])
    got = srv.drain([dict(r) for r in reqs], decode_window=8)
    after = srv.page_stats()["spec"]
    assert all(srv._graphs[key] is g for key, g in graphs.items())
    _, _, fresh = _armed(dev, layers=2)
    want = fresh.drain([dict(r) for r in reqs], decode_window=8)
    assert got == want
    for key in ("windows", "proposed", "accepted"):
        assert after[key] - before[key] == fresh.page_stats()["spec"][key]
    del junk


def test_arm_then_disarm_and_the_solo_graphs_replay(dev):
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(6)
    reqs = [{"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
             "max_new": 12, "request_id": i} for i, n in enumerate((7, 20))]
    srv = _engine("paged", cfg, params, dev)
    want = srv.drain([dict(r) for r in reqs], decode_window=8)
    solo = dict(srv._graphs)
    srv.arm_draft(*llama.truncate_layers(cfg, params, 1), k=4)
    srv.drain([dict(r) for r in reqs], decode_window=8)
    assert any(key[0] == "spec" for key in srv._graphs)
    srv.disarm_draft()
    assert not any(key[0] == "spec" for key in srv._graphs)
    before = fd.flash_decode_paged.launches
    assert srv.drain([dict(r) for r in reqs], decode_window=8) == want
    assert fd.flash_decode_paged.launches > before
    assert all(srv._graphs[key] is g for key, g in solo.items())


def test_a_spec_window_launches_kernel_2_k_times_a_draft_layer(dev):
    """A warm spec window replays its graph: kernel 2 (the draft steps)
    counts k launches a draft layer, kernel 1 none (the verify reads the
    dense gather), and no ``cudaLaunchKernel`` is made."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    srv = serving.PagedServer(cfg, params, slots=4, page_size=64,
                              prefill_chunk=16, device=dev)
    srv.arm_draft(*llama.truncate_layers(cfg, params, 2), k=3)
    _live(srv, cfg, lens=(3, 5, 7, 9))
    srv.step_many(8)
    captured = dict(srv._graphs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        srv.step_many(8)
        prof.step()
        k2, k1 = fd.flash_decode.launches, fd.flash_decode_paged.launches
        srv.step_many(8)
        prof.step()
    names = [e.name for e in prof.events()]
    assert srv._graphs == captured
    assert names.count("cudaGraphLaunch") == 1, names
    assert not [n for n in names if n.startswith("cudaLaunchKernel")]
    assert fd.flash_decode.launches - k2 == 3 * 2
    assert fd.flash_decode_paged.launches == k1


@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_equals_successive_kernel_decode_steps(dev, kv_quant):
    """The K-wide verify over the dense gather against k successive
    paged decode steps through kernel 1 on the same pool, short streams
    included: logits within the kernel-vs-dense tolerance."""
    import chip_smoke
    cfg, params, srv = _armed(dev, kv_quant)
    _live(srv, cfg, lens=(1, 2, 17, 40))
    diff = chip_smoke.verify_vs_steps(srv, atol=5e-2)
    assert diff < 5e-2


def test_speculative_decoder_runs_through_the_kernels(dev):
    """The batch-1 decoder on the card: its two prefills launch kernel 3
    once a layer, each draft chunk kernel 2 k times a draft layer, and the
    fused loop gives ``generate``'s greedy stream."""
    cfg = _cfg()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cfg_d, params_d = llama.truncate_layers(cfg, params, 1)
    dec = speculative.SpeculativeDecoder(cfg, params, cfg_d, params_d, k=4,
                                         device=dev)
    prompt = torch.tensor([[5, 17, 99, 3, 250, 1, 42, 7]], dtype=torch.int32,
                          device=dev)
    k2, k3 = fd.flash_decode.launches, fa.flash_attention_fwd.launches
    got, stats = dec.generate(prompt, 24)
    assert fd.flash_decode.launches - k2 == stats["verify_passes"] * 4
    assert fa.flash_attention_fwd.launches - k3 == cfg.n_layers + 1
    fused, fstats = dec.generate_fused(prompt, 24)
    assert fused.tolist() == got.tolist()
    assert fstats["verify_passes"] == stats["verify_passes"]
    assert tuple(got.shape) == (1, 24)
    assert all(0 <= t < cfg.vocab_size for t in got[0].tolist())


# ---------------------------------------------------------------------------
# MoE serving


def _moe_engine(dev, routing="top2", factor=None):
    """A 4-expert model on the card (head_dim 64) and its paged engine;
    dropless unless ``factor`` is given."""
    cfg = _cfg()
    params = llama.init_moe_params(
        cfg, 4, torch.Generator(device=dev).manual_seed(0), device=dev)
    moe = MoEConfig(4, routing=routing, capacity_factor=factor or 2.0)
    srv = _engine("paged", cfg, params, dev,
                  moe=moe if factor else dropless(moe))
    return cfg, srv


MOE_GRAPH_CASES = [("top2", None, 1), ("top2", None, 8), ("top2", 1.0, 8),
                   ("expert_choice", None, 4), ("expert_choice", 1.0, 8)]


@pytest.mark.parametrize("routing,factor,k", MOE_GRAPH_CASES)
def test_moe_graphed_windows_equal_the_eager_loop(dev, routing, factor, k):
    """The routed FFN inside a captured window: from one snapshot the
    graphed windows and the eager loop by hand give the same tokens and
    lengths and write the same K/V bitwise (capacity-bounded routing
    included, where the masked rows compete for capacity)."""
    cfg, srv = _moe_engine(dev, routing, factor)
    _live(srv, cfg)
    windows = 24 // k
    kv = _kv_clone(srv.pool)
    want, ln, tok = _eager_windows(srv, kv, windows, k)
    got = _graphed_windows(srv, windows, k)
    assert srv.graph_stats()["graphs"] >= 1
    for i, toks in got.items():
        assert toks == want[:, i].tolist(), i
    assert torch.equal(srv.lengths, ln) and torch.equal(srv.cur_tok, tok)
    assert _kv_equal(srv.pool, kv)


def test_moe_window_launches_kernel_1_once_a_layer_a_step(dev):
    """A warm MoE window replays kernel 1 (the paged decode kernel) once a
    layer a step, and a prefill chunk and warm-up go through the routed
    FFN without it."""
    cfg, srv = _moe_engine(dev)
    srv.warmup()
    _live(srv, cfg)
    srv.step_many(8)                      # captures the window
    fd.flash_decode_paged.launches = 0
    graphs = srv.graph_stats()["graphs"]
    for _ in range(3):
        srv.step_many(8)
    # a window that widens the table is captured first, after an eager
    # run of the same 8 steps, whose launches count
    eager = srv.graph_stats()["graphs"] - graphs
    assert fd.flash_decode_paged.launches == (3 + eager) * 8 * cfg.n_layers
    assert srv.page_stats()["moe"]["experts"] == 4


def test_generate_stepwise_moe_launches_kernel_2(dev):
    """The MoE reference decodes through the slot-cache kernel, one launch
    a layer a step."""
    cfg = _cfg()
    params = llama.init_moe_params(
        cfg, 4, torch.Generator(device=dev).manual_seed(0), device=dev)
    fd.flash_decode.launches = 0
    toks = llama.generate_stepwise_moe(
        cfg, params, torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32,
                                  device=dev), 6, dropless(MoEConfig(4)))
    assert toks.shape == (1, 6)
    assert fd.flash_decode.launches == 6 * cfg.n_layers


@pytest.mark.parametrize("routing,factor", [("top2", None), ("top2", 1.0),
                                            ("expert_choice", 1.0)])
def test_moe_apply_local_on_the_card_matches_the_cpu(dev, routing, factor):
    """fp32 (TF32 off): the same routing and outputs within 1e-5 of
    max |out| (the products' sums in another order)."""
    g = torch.Generator().manual_seed(3)
    d, e, f, n = 256, 8, 512, 64
    x = torch.randn((n, d), generator=g)
    router = torch.randn((d, e), generator=g) * d ** -0.5
    w_in = torch.randn((e, d, f), generator=g) * d ** -0.5
    w_out = torch.randn((e, f, d), generator=g) * f ** -0.5
    cfg = MoEConfig(e, routing=routing, capacity_factor=factor or 2.0)
    cfg = cfg if factor else dropless(cfg)
    want, aux_want = moe_apply_local(x, router, w_in, w_out, cfg)
    got, aux_got = moe_apply_local(*(t.to(dev) for t in
                                     (x, router, w_in, w_out)), cfg)
    got = got.cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # the same dropped rows
    assert torch.equal((got == 0).all(-1), (want == 0).all(-1))
    assert abs(float(aux_got) - float(aux_want)) <= 1e-6
