#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dcos_commons_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every kernel of ``dcos_commons_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print the card;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of the main paths and time the kernel, the plain version, one
   library call as a yardstick, and the card's bound for the same work:
   paged flash-decode (Llama-3-8B heads, B=8 ragged streams, page sizes
   64 and 128, bf16 and int8 pages); slot-cache flash-decode (Llama-3-8B
   heads, B=8 slots of a 2048-position cache, bf16 and int8, one case
   with a slot past the cache and one empty); flash-attention forward,
   dK/dV and dQ (the Llama-400m train step's B=16, S=511, H=12, KV=6,
   D=128, and Llama-3-8B heads B=2, S=2048, H=32, KV=8), and the forward
   alone at the slot-prefill bucket (B=8, S=2048, Llama-3-8B heads), each
   flash-attention case with its share of the bound, and the port's
   whole backward (rowsum pass and both kernels) beside SDPA's;
3. serve Llama-3-8B (full width and depth, random bf16 weights from a
   seed) through ``PagedServer``: about a dozen requests, two sharing a
   long prefix, decode windows 1 and 8; launch counts are zeroed just
   before and read just after; then one decode step through the kernel
   is held against the same step through the dense gather;
5. (run right after phase 3, on its weights) serve Llama-3-8B through
   ``SlotServer(slots=8)`` behind the HTTP front door
   (``ServingFrontend`` on 127.0.0.1, decode window 8): a dozen
   concurrent ``POST /v1/generate`` requests, two of them streamed, then
   ``/v1/healthz`` and ``/v1/stats``, and one solo ``generate_chunked``;
   launch counts are zeroed just before and read just after; then one
   ``decode_step_slots`` through the kernel is held against the dense
   step on the live cache, and 16 steady decode steps at B=8 are timed;
4. train ``llama_400m`` (full width and depth, bench.py's headline shape:
   batch 16 x 512 tokens, fused cross-entropy, AdamW with warmup 10):
   one warm-up step, then 10 timed steps on the same batch with the
   flash-attention launch counts zeroed just before and read just after;
   then one loss forward and backward through the kernels is held
   against the same through the dense attention path.

Output: the ``serving``, ``serving_slots`` and ``training`` lines, the
``kernels`` line, the card's name and power limit, and last ``{"ok": true,
"device": {...}}``. Without CUDA, or without the rest of the repository
beside it, it exits non-zero and prints no result. Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time
import urllib.request

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16
# tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
SEED = 0
# about 25 ms of SM clock: longer than the host takes to queue a timing run
SLEEP_CYCLES = 50_000_000

# kernel vs plain version: both accumulate in fp32 and round once to
# bf16, so they differ by at most about one bf16 ulp (2^-7 relative)
KERNEL_RTOL, KERNEL_ATOL = 1e-2, 1e-3
# flash attention, kernel vs plain version: both accumulate in fp32 and
# round each output once to bf16, but the kernels round P (and dS) to bf16
# before their products, as the TPU kernel does, so an output may flip its
# last bf16 bits and the error scales with the largest value: rtol 2e-2
# plus 1e-2 of max|want| over each row of a head for O, over the tensor
# for a gradient (fa_check); lse is fp32 on both sides
FA_RTOL, FA_SCALED_ATOL, LSE_ATOL = 2e-2, 1e-2, 1e-3
# the train step, one loss forward + backward through the kernels vs the
# dense path, both bf16 over 8 layers: loss within 2e-2 (about 3 bf16
# ulps of the ~10.4 loss, carried by bf16 rounding flips in attention);
# each gradient leaf within 5e-2 relative in norm
LOSS_ATOL, GRAD_RTOL = 2e-2, 5e-2
# one decode step, kernel vs dense gather, over 32 bf16 layers: attention
# outputs differ by bf16 rounding flips, which the residual stream carries
# to the bf16-rounded logits (ulp 2^-7 near 1): allow 16 ulps there
LOGIT_ATOL = 0.125


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (the main paths find their inputs cold). A sleep kernel
    first holds the card while the host queues every launch, so the
    events time the device, not the host's gaps between launches."""
    import torch
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for the work: bytes over the memory rate or bf16
    operations over the tensor-core peak, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


# --------------------------------------------------------------- phase 1


def phase_build() -> None:
    from dcos_commons_tpu_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in build.log_path(name).read_text().splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------- phase 2

KV_LENS = (1, 63, 64, 65, 700, 2047, 1500, 333)


def flash_decode_case(ps: int, int8: bool, flush) -> dict:
    """Kernel vs plain version at the 8B decode shape: H=32, KV=8,
    D=128, B=8 streams of ragged length, shuffled page table."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.models.llama import _gather_pages
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.ops.quant import quantize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + ps + int8)
    b, h, kv, d, max_seq = 8, 32, 8, 128, 2048
    mp = max_seq // ps
    pages = b * mp + 1
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    shape = (pages, ps, kv, d)
    k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    if int8:
        k, v = quantize(k, axis=-1), quantize(v, axis=-1)
    perm = torch.randperm(pages - 1, generator=g, device=dev)
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    kv_len = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)

    got = fd.flash_decode_paged(q, k, v, table, kv_len)
    want = fd.flash_decode_paged_reference(q, k, v, table, kv_len)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError(
            f"flash_decode_paged ps={ps} int8={int8}: {int(bad.sum())} "
            f"elements off (max abs err {float(err.max()):.3e})")

    # yardstick: SDPA over pre-gathered (dequantized) pages, masked at
    # kv_len; timed here only, never called by the port
    kg = _gather_pages(k, table, torch.bfloat16).transpose(1, 2)
    vg = _gather_pages(v, table, torch.bfloat16).transpose(1, 2)
    span = mp * ps
    mask = (torch.arange(span, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float()
                     - want.float()).abs().max())
    iters = 50
    ms = timed_ms(lambda: fd._launch_paged(q, k, v, table, kv_len,
                                           d ** -0.5), iters, flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_paged_reference(
        q, k, v, table, kv_len), 10, flush)
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(n, span) for n in KV_LENS)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * mp * 4 + b * 4
    return {"page_size": ps, "pages": "int8" if int8 else "bf16",
            "max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            **bound(kv_bytes + io_bytes, 4 * live * h * d)}


# slot lengths of the edge case: one past the cache, one empty
EDGE_LENS = (4096, 0, 64, 65, 700, 2047, 1500, 333)


def slot_decode_case(int8: bool, kv_lens, flush) -> dict:
    """Kernel 2 vs its plain version at the 8B slot shape: H=32, KV=8,
    D=128, B=8 slots of a 2048-position cache read in place."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.ops.quant import dequantize, quantize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7 + int8)
    b, h, kv, d, s = 8, 32, 8, 128, 2048
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=g, device=dev).to(torch.bfloat16)
    if int8:
        k, v = quantize(k, axis=-1), quantize(v, axis=-1)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)

    got = fd.flash_decode(q, k, v, kv_len)
    want = fd.flash_decode_reference(q, k, v, kv_len)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    dead = [i for i, n in enumerate(kv_lens) if n <= 0]
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()) \
            or any(bool((got[i] != 0).any()) for i in dead):
        raise RuntimeError(
            f"flash_decode int8={int8} lens={kv_lens}: {int(bad.sum())} "
            f"elements off (max abs err {float(err.max()):.3e})")

    # yardstick: SDPA over the (dequantized) cache masked at kv_len; timed
    # here only, never called by the port
    kd = dequantize(k, torch.bfloat16) if int8 else k
    vd = dequantize(v, torch.bfloat16) if int8 else v
    kt, vt, qt = kd.transpose(1, 2), vd.transpose(1, 2), q.transpose(1, 2)
    mask = (torch.arange(s, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    live_rows = [i for i, n in enumerate(kv_lens) if n > 0]
    lib_err = float((library().transpose(1, 2).float()
                     - want.float())[live_rows].abs().max())
    lens = fd._lengths(kv_len, b, q.device)
    iters = 50
    ms = timed_ms(lambda: fd._launch_slots(q, k, v, lens, d ** -0.5), iters,
                  flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_reference(q, k, v, kv_len),
                        10, flush)
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(max(n, 0), s) for n in kv_lens)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * 4
    return {"cache": "int8" if int8 else "bf16", "kv_len": list(kv_lens),
            "max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            **bound(kv_bytes + io_bytes, 4 * live * h * d)}


# (name, B, S, H, KV, D): causal, q_offset 0; the first is the main path
FA_SHAPES = (("llama_400m_train", 16, 511, 12, 6, 128),
             ("llama3_8b_heads", 2, 2048, 32, 8, 128))
# forward only: the slot-prefill bucket that serving runs ([8, 2048])
FA_FWD_SHAPES = (("llama3_8b_prefill_b8", 8, 2048, 32, 8, 128),)


def fa_check(name: str, got, want, rows: bool = True) -> tuple:
    """(max abs error, worst error as a share of its limit) of a
    flash-attention output against its plain version: FA_RTOL plus
    FA_SCALED_ATOL of max|want|, taken over each row of a head (``rows``,
    for O: under a causal mask an early row, |o| near 4, would otherwise
    set the limit for a late one, |o| near 0.04) or over the tensor (for
    a gradient, whose rows can cancel to 0: dQ of a row that sees only
    its own key). Raises outside the limit or on a non-finite value."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = w.abs().amax(dim=-1, keepdim=True) if rows else w.abs().max()
    tol = FA_SCALED_ATOL * scale + FA_RTOL * w.abs()
    share = float((err / tol.clamp_min(1e-30)).max())
    if share > 1.0 or not bool(torch.isfinite(g).all()):
        raise RuntimeError(f"{name}: {int((err > tol).sum())} elements off "
                           f"(max abs err {float(err.max()):.3e}, worst "
                           f"error {share:.3g} x its limit)")
    return float(err.max()), share


def fa_inputs(shape):
    """q, k, v and dO at one shape, from the seed."""
    import torch
    _, b, s, h, kv, d = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + s)

    def r(*dims):
        return torch.randn(dims, generator=g, device="cuda").to(torch.bfloat16)

    return r(b, s, h, d), r(b, s, kv, d), r(b, s, kv, d), r(b, s, h, d)


def fa_entry(shape, kern, checked, ms, plain_ms, library_ms) -> dict:
    """One case of kernel ``kern`` (fwd, dkdv or dq) with its bound."""
    label, b, s, h, kv, d = shape
    # live (query, key) pairs of the causal mask, each row i sees i + 1
    pairs = b * h * s * (s + 1) // 2
    q_bytes = b * s * h * d * 2                     # q, o, dO, dq (bf16)
    kv_bytes = b * s * kv * d * 2                   # k, v, dk, dv (bf16)
    row_bytes = b * h * s * 4                       # lse, delta (fp32)
    work = {"fwd": (2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * d * pairs),
            "dkdv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
                     8 * d * pairs),
            "dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                   6 * d * pairs)}[kern]
    err, share = checked
    return {"shape": label, "b": b, "s": s, "h": h, "kv": kv, "d": d,
            "max_abs_err": err, "err_share_of_limit": share, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **bound(*work)}


def flash_attention_fwd_case(shape, flush) -> dict:
    """Kernel 3 vs its plain version at one shape, with its time, its
    bound and its share of it, and SDPA's forward as the library
    yardstick, timed here only and never called by the port."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    label = shape[0]
    q, k, v, _ = fa_inputs(shape)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    checked = fa_check(f"flash_attention_fwd {label}", o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    if lse_err > LSE_ATOL:
        raise RuntimeError(f"flash_attention_fwd {label}: lse off by "
                           f"{lse_err:.3e}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float()
                     - o_ref.float()).abs().max())
    iters = 20
    out = fa_entry(
        shape, "fwd", checked,
        timed_ms(lambda: fa.flash_attention_fwd(q, k, v), iters, flush),
        timed_ms(lambda: fa.flash_attention_reference(q, k, v), 3, flush),
        timed_ms(library, iters, flush))
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["lse_max_abs_err"] = lse_err
    out["library_max_abs_err"] = lib_err
    return out


def flash_attention_bwd_case(shape, flush, dkdv=None, dq=None,
                             plain: bool = True) -> tuple:
    """Kernels 4 and 5 vs their plain versions at one shape, from the
    plain forward's lse, with their times, bounds and shares of them;
    SDPA's backward (dQ, dK and dV together, its rowsum pass included) as
    the library yardstick of both, and beside it the port's whole
    backward (``attention_delta`` and both kernels, as ``_FlashAttention``
    runs it). ``dkdv``/``dq`` default to the wrappers; another launcher of
    the same signature (a variant's source) can stand in, and ``plain``
    False skips timing the plain versions."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    run_dkdv = dkdv or fa.flash_attention_bwd_dkdv
    run_dq = dq or fa.flash_attention_bwd_dq
    label = shape[0]
    q, k, v, do = fa_inputs(shape)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v)
    delta = fa.attention_delta(o_ref, do)
    bwd_in = (q, k, v, do, lse_ref, delta)
    dk, dv = run_dkdv(*bwd_in)
    dq_out = run_dq(*bwd_in)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkdv_reference(*bwd_in)
    dq_ref = fa.flash_attention_bwd_dq_reference(*bwd_in)
    torch.cuda.synchronize()
    checked_dkdv = max(
        fa_check(f"flash_attention_bwd_dkdv {label} dk", dk, dk_ref,
                 rows=False),
        fa_check(f"flash_attention_bwd_dkdv {label} dv", dv, dv_ref,
                 rows=False))
    checked_dq = fa_check(f"flash_attention_bwd_dq {label}", dq_out, dq_ref,
                          rows=False)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    do_t = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, leaves, do_t, retain_graph=True)

    def port_backward():
        d = fa.attention_delta(o_ref, do)
        return run_dkdv(q, k, v, do, lse_ref, d), run_dq(q, k, v, do,
                                                          lse_ref, d)

    iters = 20
    lib_ms = timed_ms(library, iters, flush)
    whole_ms = timed_ms(port_backward, iters, flush)
    dkdv_entry = fa_entry(
        shape, "dkdv", checked_dkdv,
        timed_ms(lambda: run_dkdv(*bwd_in), iters, flush),
        timed_ms(lambda: fa.flash_attention_bwd_dkdv_reference(*bwd_in), 5,
                 flush) if plain else None, lib_ms)
    dq_entry = fa_entry(
        shape, "dq", checked_dq,
        timed_ms(lambda: run_dq(*bwd_in), iters, flush),
        timed_ms(lambda: fa.flash_attention_bwd_dq_reference(*bwd_in), 5,
                 flush) if plain else None, lib_ms)
    for entry in (dkdv_entry, dq_entry):
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["port_backward_ms"] = whole_ms
    return dkdv_entry, dq_entry


def phase_kernels(flush):
    cases = [flash_decode_case(ps, int8, flush)
             for ps in (64, 128) for int8 in (False, True)]
    for c in cases:
        log(f"[kernel] flash_decode_paged {json.dumps(c)}")
    slot_cases = [slot_decode_case(int8, lens, flush)
                  for int8, lens in ((False, KV_LENS), (True, KV_LENS),
                                     (True, EDGE_LENS))]
    for c in slot_cases:
        log(f"[kernel] flash_decode {json.dumps(c)}")
    fa_cases = {"fwd": [flash_attention_fwd_case(shape, flush)
                        for shape in FA_SHAPES + FA_FWD_SHAPES],
                "dkdv": [], "dq": []}
    for shape in FA_SHAPES:
        dkdv, dq = flash_attention_bwd_case(shape, flush)
        fa_cases["dkdv"].append(dkdv)
        fa_cases["dq"].append(dq)
    for kern, kern_cases in fa_cases.items():
        for c in kern_cases:
            log(f"[kernel] flash_attention_{kern} {json.dumps(c)}")
    return cases, slot_cases, fa_cases


# --------------------------------------------------------------- phase 3


def _prompt(rng, n, vocab):
    return [int(t) for t in rng.integers(0, vocab, n)]


def phase_serve(card: str) -> dict:
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] init 8B params in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    v = cfg.vocab_size
    # two requests share a 319-token prefix: 4 full radix pages of 64
    # (the lookup hit) plus 63 tokens of the fifth (the boundary COW)
    base = _prompt(rng, 320, v)
    alt = (base[319] + 1) % v
    lens = (64, 1500, 300, 777, 128, 1024, 95, 640, 1200, 411)
    queue = [{"prompt": _prompt(rng, n, v), "max_new": 32,
              "request_id": f"r{i}"} for i, n in enumerate(lens)]
    queue.insert(2, {"prompt": base + _prompt(rng, 380, v), "max_new": 32,
                     "request_id": "prefix-a"})
    queue.append({"prompt": base[:319] + [alt] + _prompt(rng, 200, v),
                  "max_new": 32, "request_id": "prefix-b"})
    runs = [(queue[:6], 1), (queue[6:], 8)]     # (requests, decode window)

    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, device=dev)
    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode_paged.launches = 0
    ttft, t_start = {}, time.perf_counter()
    for reqs, window in runs:
        t_sub = time.perf_counter()
        pending = list(reqs)
        while pending or srv.requests_active():
            placed = srv.submit_many(pending)
            pending = pending[len(placed):]
            srv.step_many(window)
            now = time.perf_counter()
            for r in srv.requests:
                if r is not None and r.tokens and r.request_id not in ttft:
                    ttft[r.request_id] = now - t_sub
            for rid in srv.finished:
                ttft.setdefault(rid, now - t_sub)
    wall = time.perf_counter() - t_start
    launches = fd.flash_decode_paged.launches
    out = srv.finished
    problems = []
    if sorted(out) != sorted(r["request_id"] for r in queue):
        problems.append(f"finished {sorted(out)}")
    short = {k: len(t) for k, t in out.items() if len(t) != 32}
    if short:
        problems.append(f"requests without 32 tokens: {short}")
    if any(not 0 <= t < v for toks in out.values() for t in toks):
        problems.append("token outside the vocabulary")
    if srv.ledger_violations():
        problems.append(f"ledger: {srv.ledger_violations()[:3]}")
    stats = srv.page_stats()
    if stats["prefix_hits"] < 1:
        problems.append(f"no prefix hit: {stats}")
    if launches < 1:
        problems.append("flash_decode_paged never launched on the main path")
    if problems:
        raise RuntimeError("serving phase: " + "; ".join(problems))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(t) for t in out.values())
    log(f"[serve] {len(out)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"{launches} kernel launches, stats {stats}")

    # steady decode at B=8 and one step, kernel vs dense gather, on the
    # live pool of 8 prefilled streams
    srv.reset()
    rng = np.random.default_rng(SEED + 1)
    # max_new outlasts the 67 steps the longest prompt takes to prefill
    live = [{"prompt": _prompt(rng, n, v), "max_new": 200,
             "request_id": i} for i, n in enumerate(
                 (1, 63, 64, 65, 700, 1500, 1300, 333))]
    srv.submit_many(live)
    while srv._prefill_q or srv._pending_first:
        srv.step()
    active = srv._active()
    if len(active) != 8:
        raise RuntimeError(f"expected 8 decoding streams, got {active}")
    mp = srv._window_mp(active, 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=dev)
    logits = {}
    for mode in ("flash", "dense"):
        pool = {side: p.clone() for side, p in srv.pool.items()}
        logits[mode], _ = llama.decode_step_paged(
            dataclasses.replace(cfg, decode_attn=mode), params, pool, tbl,
            srv.lengths, srv.cur_tok, rope=srv._rope)
        del pool
    diff, decided = _kernel_vs_dense(logits["flash"], logits["dense"])
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        srv.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    ttfts = sorted(ttft.values())
    return {"serving": {
        "model": "llama3_8b", "max_seq": cfg.max_seq, "layers": cfg.n_layers,
        "dtype": "bf16", "slots": 8, "page_size": 64, "prefill_chunk": 64,
        "requests": len(out), "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "decode_tok_s_b8": 8 * steps / decode_s,
        "decode_step_ms_b8": decode_s / steps * 1e3,
        "peak_mem_gb": peak_gb, "page_stats": stats,
        "flash_vs_dense_max_abs_logit": diff,
        "flash_vs_dense_argmax_decided": int(decided.sum()),
        "card": card}}, launches, params


def _kernel_vs_dense(lf, ld):
    """Max |logit difference| of a decode step through the kernel vs the
    dense read, and how many rows have a decided argmax (top two apart by
    more than the tolerance); raises if they disagree."""
    import torch
    diff = float((lf - ld).abs().max())
    top2 = torch.topk(ld, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
    agree = (lf.argmax(-1) == ld.argmax(-1)) | ~decided
    if diff > LOGIT_ATOL or not bool(agree.all()) \
            or not bool(torch.isfinite(lf).all()):
        raise RuntimeError(f"decode step kernel vs dense: max |dlogit| "
                           f"{diff:.4f} (tol {LOGIT_ATOL}), argmax agree "
                           f"{agree.tolist()}")
    return diff, decided


# --------------------------------------------------------------- phase 5

SLOT_LENS = (64, 1500, 300, 777, 128, 1024, 95, 640, 1200, 411, 256, 900)
STREAMED = (1, 6)          # request indices sent with "stream": true


def _http_generate(port: int, body: dict) -> dict:
    """One ``POST /v1/generate``; a streamed reply is read line by line
    and folded into the unary reply's shape."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            return json.loads(r.read())
        lines = [json.loads(raw) for raw in r]
    done = lines[-1]
    if not done.get("done") or "error" in done:
        raise RuntimeError(f"stream ended badly: {done}")
    return {"tokens": [e["token"] for e in lines if "token" in e], **done}


def _http_get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def phase_serve_slots(card: str, params):
    """The worker's default engine: Llama-3-8B (max_seq 2048) in
    ``SlotServer(slots=8)`` behind ``ServingFrontend``."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.models.ingress import ServingFrontend
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    v = cfg.vocab_size
    rng = np.random.default_rng(SEED + 2)
    bodies = [{"prompt": _prompt(rng, n, v), "max_new": 32,
               "stream": i in STREAMED} for i, n in enumerate(SLOT_LENS)]
    solo_prompt = _prompt(rng, 256, v)
    srv = serving.SlotServer(cfg, params, slots=8, device=dev)
    fe = ServingFrontend(srv, port=0, host="127.0.0.1", decode_window=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode.launches = 0
    fa.flash_attention_fwd.launches = 0
    fe.start()
    try:
        replies = [None] * len(bodies)
        errors = []

        def hit(i):
            try:
                replies[i] = _http_generate(fe.port, bodies[i])
            except Exception as e:          # reported below, all at once
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        health = _http_get(fe.port, "/v1/healthz")
        stats = _http_get(fe.port, "/v1/stats")
    finally:
        fe.stop()
    solo = llama.generate_chunked(
        cfg, params, torch.tensor([solo_prompt], dtype=torch.int32,
                                  device=dev), 32, chunk=16)
    torch.cuda.synchronize()
    launches = {"flash_decode": fd.flash_decode.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    problems = list(errors)
    if any(t.is_alive() for t in threads):
        problems.append("a request thread did not finish")
    for i, r in enumerate(replies):
        toks = (r or {}).get("tokens", [])
        if len(toks) != 32 or not all(0 <= t < v for t in toks):
            problems.append(f"request {i}: {len(toks)} tokens, in vocab "
                            f"{all(0 <= t < v for t in toks)}")
    if stats["requests"] != len(bodies) or stats["tokens"] != 32 * len(
            bodies):
        problems.append(f"/v1/stats counts {stats['requests']} requests, "
                        f"{stats['tokens']} tokens")
    if not health["ok"] or health["free"] != 8:
        problems.append(f"/v1/healthz {health}")
    if tuple(solo.shape) != (1, 32) or not bool(
            ((solo >= 0) & (solo < v)).all()):
        problems.append(f"solo generate_chunked gave {tuple(solo.shape)}")
    for name, n in launches.items():
        if n < 1:
            problems.append(f"{name} never launched on the main path")
    if problems:
        raise RuntimeError("slot serving phase: " + "; ".join(problems))
    n_tok = sum(len(r["tokens"]) for r in replies)
    log(f"[slots] {len(replies)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"launches {launches}, stats {stats}")

    # one step through the kernel vs the dense read on a live cache of 8
    # slots, then steady decode at B=8
    rng = np.random.default_rng(SEED + 3)
    srv.submit_many([{"prompt": _prompt(rng, n, v), "max_new": 200,
                      "request_id": i} for i, n in enumerate(
                          (1, 63, 64, 65, 700, 1500, 1300, 333))])
    srv.step()
    if len(srv.free_slots()) != 0:
        raise RuntimeError(f"expected 8 live slots, free {srv.free_slots()}")
    logits = {}
    for mode in ("flash", "dense"):
        cache = {side: c.clone() for side, c in srv.cache.items()}
        logits[mode], _ = llama.decode_step_slots(
            dataclasses.replace(cfg, decode_attn=mode), params, cache,
            srv.lengths, srv.cur_tok, rope=srv._rope)
        del cache
    diff, decided = _kernel_vs_dense(logits["flash"], logits["dense"])
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        srv.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"serving_slots": {
        "model": "llama3_8b", "max_seq": cfg.max_seq, "layers": cfg.n_layers,
        "dtype": "bf16", "engine": "SlotServer", "slots": 8,
        "front_door": "ServingFrontend", "decode_window": 8,
        "requests": len(replies), "streamed": len(STREAMED),
        "tokens_out": n_tok, "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "decode_tok_s_b8": 8 * steps / decode_s,
        "decode_step_ms_b8": decode_s / steps * 1e3,
        "peak_mem_gb": peak_gb, "launches": launches,
        "solo_generate_chunked": {"batch": 1, "chunk": 16, "steps": 32},
        "flash_vs_dense_max_abs_logit": diff,
        "flash_vs_dense_argmax_decided": int(decided.sum()),
        "card": card}}, launches


# --------------------------------------------------------------- phase 4

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 512, 10
FA_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
              "flash_attention_bwd_dq")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def phase_train(card: str):
    """bench.py's headline llama line through the port: llama_400m at
    full width and depth, batch 16 x 512, fused CE, AdamW warmup 10."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, train
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama_400m(max_seq=TRAIN_SEQ, remat=False)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    named = list(_named(params))
    n_params = sum(t.numel() for _, t in named)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    opt = train.make_optimizer(lr=3e-4, warmup=10, decay_steps=1000)
    state = train.init_opt_state(opt, params)
    step = train.make_train_step(lambda p, b: llama.loss_fn(cfg, p, b), opt)

    t0 = time.perf_counter()
    params, state, out = step(params, state, toks)          # warm-up
    losses = [out["loss"]]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counters = [getattr(fa, name) for name in FA_KERNELS]
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, out = step(params, state, toks)
        losses.append(out["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {name: c.launches for name, c in zip(FA_KERNELS, counters)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in torch.stack(losses).float().cpu()]
    log(f"[train] warm-up step {warm_s:.2f} s, {step_s * 1e3:.2f} ms a "
        f"step, losses {losses}, launches {launches}")

    # one loss forward + backward through the kernels vs the dense path
    grads, loss = {}, {}
    leaves = [t for _, t in named]
    for mode in ("auto", "dense"):
        for t in leaves:
            t.requires_grad_(True)
        l_mode, _ = llama.loss_fn(dataclasses.replace(cfg, attn_impl=mode),
                                  params, toks)
        grads[mode] = torch.autograd.grad(l_mode, leaves)
        loss[mode] = float(l_mode.detach())
        for t in leaves:
            t.requires_grad_(False)
    rel = {name: float((gk.float() - gd.float()).norm()
                       / gd.float().norm().clamp_min(1e-30))
           for (name, _), gk, gd in zip(named, grads["auto"], grads["dense"])}
    worst = max(rel, key=rel.get)
    loss_diff = abs(loss["auto"] - loss["dense"])

    problems = []
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        problems.append(f"launches {launches}, expected {want} of each")
    if not all(np.isfinite(losses)):
        problems.append(f"non-finite loss: {losses}")
    elif not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses}")
    if loss_diff > LOSS_ATOL or rel[worst] > GRAD_RTOL:
        problems.append(f"kernel vs dense: loss diff {loss_diff:.3e} (tol "
                        f"{LOSS_ATOL}), worst grad {worst} {rel[worst]:.3e} "
                        f"(tol {GRAD_RTOL})")
    if problems:
        raise RuntimeError("training phase: " + "; ".join(problems))

    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ - 1)  # next-token loss
    flops_per_step = 6.0 * n_params * tokens_per_step
    return {"training": {
        "model": "llama_400m", "layers": cfg.n_layers, "dim": cfg.dim,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "params": n_params, "dtype": "bf16", "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "tokens_per_step": tokens_per_step,
        "grad_accum": 1, "fused_ce": cfg.fused_ce, "remat": cfg.remat,
        "attn_impl": cfg.attn_impl, "steps_timed": TRAIN_STEPS,
        "warmup_step_s": warm_s, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens_per_step / step_s,
        "mfu": flops_per_step / step_s / BF16_OPS_PER_S,
        "bound_step_ms": flops_per_step / BF16_OPS_PER_S * 1e3,
        "peak_mem_gb": peak_gb, "loss_first": losses[0],
        "loss_last": losses[-1], "losses": losses,
        "launches_per_step": {k: n / TRAIN_STEPS
                              for k, n in launches.items()},
        "kernel_vs_dense": {
            "loss_kernel": loss["auto"], "loss_dense": loss["dense"],
            "loss_abs_diff": loss_diff, "loss_tol": LOSS_ATOL,
            "grad_max_rel_err": rel[worst], "grad_worst_leaf": worst,
            "grad_tol": GRAD_RTOL},
        "card": card}}, launches


def _kernel_entry(name, source, replaces, launches, cases, tolerance):
    """``launches``: {main path: count}; the entry's count is their sum."""
    head = cases[0]                        # the main path's shape
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "tolerance": tolerance,
            "cases": cases}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    card = card_line()
    log(f"[card] {card}")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    decode_cases, slot_cases, fa_cases = phase_kernels(flush)
    del flush
    serving_line, decode_launches, params = phase_serve(card)
    torch.cuda.empty_cache()
    slots_line, slot_launches = phase_serve_slots(card, params)
    del params
    # the front door's handler closes over the front door, a cycle that
    # holds the engine (and the 8B weights) until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    training_line, fa_launches = phase_train(card)
    fa_tol = {"rtol": FA_RTOL,
              "atol": f"{FA_SCALED_ATOL} * max|plain| of each row of a head "
                      "(O) or of the tensor (gradients)",
              "lse_atol": LSE_ATOL}
    csrc = "dcos_commons_tpu_torch/csrc/"
    decode_tol = {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL}
    kernels = [
        _kernel_entry("flash_decode_paged", csrc + "flash_decode_paged.cu",
                      "dcos_commons_tpu/ops/flash_decode.py:263",
                      {"serving": decode_launches}, decode_cases,
                      decode_tol),
        _kernel_entry("flash_decode", csrc + "flash_decode_slots.cu",
                      "dcos_commons_tpu/ops/flash_decode.py:55",
                      {"serving_slots": slot_launches["flash_decode"]},
                      slot_cases, decode_tol),
        _kernel_entry("flash_attention_fwd", csrc + "flash_attention_fwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:62",
                      {"serving_slots": slot_launches["flash_attention_fwd"],
                       "training": fa_launches["flash_attention_fwd"]},
                      fa_cases["fwd"], fa_tol),
        _kernel_entry("flash_attention_bwd_dkdv",
                      csrc + "flash_attention_bwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:214",
                      {"training": fa_launches["flash_attention_bwd_dkdv"]},
                      fa_cases["dkdv"], fa_tol),
        _kernel_entry("flash_attention_bwd_dq",
                      csrc + "flash_attention_bwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:256",
                      {"training": fa_launches["flash_attention_bwd_dq"]},
                      fa_cases["dq"], fa_tol),
    ]
    sdpa = "scaled_dot_product_attention(attn_mask=kv_len, enable_gqa) over "
    kernels[0]["library"] = sdpa + "pre-gathered (dequantized) pages"
    kernels[1]["library"] = sdpa + "the (dequantized) slot cache"
    for k in kernels[2:]:
        k["library"] = ("scaled_dot_product_attention(is_causal, enable_gqa)"
                        + (" forward" if k["name"].endswith("fwd") else
                           " backward: dq, dk and dv together"))
    print(json.dumps(serving_line), flush=True)
    print(json.dumps(slots_line), flush=True)
    print(json.dumps(training_line), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
