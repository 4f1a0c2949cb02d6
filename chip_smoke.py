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
   64 and 128, bf16 and int8 pages, and 16 in bf16); slot-cache
   flash-decode (Llama-3-8B heads, B=8 slots of a 2048-position cache,
   bf16 and int8, and a case in each with a slot past the cache and one
   empty), each decode case with its share of the bound, a second call on
   other inputs and 20 more launches that must give the first call's
   bits; flash-attention forward,
   dK/dV and dQ (the Llama-400m train step's B=16, S=511, H=12, KV=6,
   D=128, Llama-3-8B heads B=2, S=2048, H=32, KV=8, and the distill
   step's B=32, S=256 at those heads), and the forward alone at the
   slot-prefill bucket (B=8, S=2048, Llama-3-8B heads), each
   flash-attention case with its share of the bound, and the port's
   whole backward (rowsum pass and both kernels) beside SDPA's;
3. serve Llama-3-8B (full width and depth, random bf16 weights from a
   seed) through ``PagedServer`` with a compile cache, after
   ``warmup()``: about a dozen requests, two sharing a long prefix,
   decode windows 1 and 8, every window a CUDA graph; launch counts are
   zeroed just before and read just after (a graph replay counts the
   launches it holds); then one decode step through the kernel is held
   against the same step through the dense gather; then, from one
   snapshot of 8 live streams, 6 windows of 8 steps run through the
   eager model-function loop driven by hand and through the graphs,
   each window timed unprofiled, and must give the same tokens and
   lengths; then a second engine of the same key warms up;
7. (right after phase 3, on its weights) speculative decoding: the same
   ``PagedServer`` armed with ``truncate_layers(cfg, params, 1)`` at k=4
   serves phase 3's 12 requests, each stream teacher-forced through the
   target (every token's logit within ``NEAR_TIE_ATOL`` of the top at
   its position, so it leaves phase 3's solo stream only at a near-tie
   and is held after it too), kernel 2 launched
   k times a window and kernel 3 once a draft prefill; after a reset, 6
   spec windows at B=8 through the graphs and through the eager loop by
   hand must give the same tokens, ``n_emit``, lengths and live K/V rows
   (pool and draft cache); the self-draft (all 32 layers) serves 4 of
   the requests (three, then prefix-b alone on prefix-a's radix pages;
   each drain must accept ``SELF_DRAFT_ACCEPT_FLOOR`` of its
   proposals), then from a snapshot of those 4 streams runs eager
   windows in which every rejected proposal must sit at a near-tie of
   the verify's logits;
   then ``save_draft`` writes the 1-layer draft under
   ``build/spec_draft`` for the worker below;
5. (on phase 3's weights) serve Llama-3-8B through
   ``SlotServer(slots=8)`` behind the HTTP front door
   (``ServingFrontend`` on 127.0.0.1, decode window 8): a dozen
   concurrent ``POST /v1/generate`` requests, two of them streamed, then
   ``/v1/healthz`` and ``/v1/stats``, and one solo ``generate_chunked``;
   launch counts are zeroed just before and read just after; then one
   ``decode_step_slots`` through the kernel is held against the dense
   step on the live cache, and the graphed windows against the eager
   loop as in phase 3;
6. start the port's worker as the scheduler would, ``python -m
   dcos_commons_tpu_torch.frameworks.worker llama --preset 8b --serve
   --slots 8`` (Llama-3-8B in the default ``SlotServer``), send it 8
   concurrent requests (one streamed), check ``/v1/healthz``,
   ``/v1/stats`` and a heartbeat, and end it with SIGTERM; then the same
   with ``--pages 64`` (``PagedServer``); each worker's launch counts are
   its own while it served (its heartbeat's less its ``serving``
   event's); then (phase 7) the worker with ``--pages 64 --spec-decode
   true --draft-checkpoint build/spec_draft --draft-k 4``: a
   ``spec_armed`` event (a ``spec_fallback`` fails), the same 8 requests,
   tokens held to the paged worker's under the near-tie rule, spec
   windows in ``/v1/stats``;
8. (right after phase 2, in a process of its own) the worker's
   ``distill --preset 8b --draft-layers 1 --batch 32 --seq 256 --steps
   20 --out DIR``: exit 0, finite falling losses, kernels 3-5 launched
   once a layer a step by the run's own counts (no attention dense), the
   checkpoint and the sealed draft saved, step time and peak memory
   beside the reckoning; then (after phase 7's worker) the worker with
   ``--pages 64 --spec-decode true --draft-checkpoint DIR/draft``:
   ``spec_armed``, phase 6's 8 requests, every token held to the target
   under the near-tie rule, its acceptance beside the truncated draft's;
10. (after the dense 8B phases free their weights) MoE serving at
   Llama-3-8B widths and depth with 8 experts, top-2, dropless (the
   Mixtral-8x7B routing geometry, 64.9 GB of random bf16 weights from the
   seed): ``PagedServer(moe=...)`` after ``warmup()`` drains phase 3's 12
   requests and the workers' 8, and ``generate_stepwise_moe`` decodes
   phase 3's 12 alone (kernel 2), with the kernel counts zeroed just
   before and read just after; the engine's streams, teacher-forced
   through the MoE target, must put ``MOE_NEAR_TIE_SHARE`` of their
   tokens within ``NEAR_TIE_ATOL`` of the top logit (bf16 routing flips
   let a stream leave the reference at any token: see there), and in
   fp32 at ``MOE_FP32_LAYERS`` layers of the full width every stream
   must equal ``generate_stepwise_moe``; ``moe_apply_local`` on the card
   is held to the port's CPU result in fp32, and the graphed windows at
   B=8 bitwise to the eager loop; then the worker with
   ``dist/moe.yml``'s flags (``--pages -1 --moe-experts 8
   --moe-capacity-factor 0``): a ``moe_fallback`` or ``paged_fallback``
   fails, its replies are held to the in-process engine's streams for
   the same prompts (by the same share where they leave them);
4. train ``llama_400m`` (full width and depth, bench.py's headline shape:
   batch 16 x 512 tokens, fused cross-entropy, AdamW with warmup 10):
   one warm-up step, then 10 timed steps on the same batch with the
   flash-attention launch counts zeroed just before and read just after;
   then one loss forward and backward through the kernels is held
   against the same through the dense attention path;
9. the worker's ``llama-train`` (tiny, head_dim 8; ``--attn auto`` is
   dense, as the reference's ``auto`` under its train mesh, no kernel
   launched): a fresh ``--steps 3`` (counts 4 saved), a ``--steps 5``
   that resumes at 3, and a ``--ckpt-every 1`` run SIGTERM'd after its
   first checkpoint (``sigterm``, ``preempted``, exit 143) whose
   relaunch resumes at the flushed step; then ``--attn flash --steps 2``
   through kernels 3-5 (head_dim 8 zero-padded to 64), one launch of
   each a layer a step.

Each phase's wall seconds go to stderr as it ends and into the
``phase_s`` line. Output: the ``serving``, ``serving_slots``,
``worker``, ``worker_paged``, ``worker_spec``, ``worker_distilled``,
``training``, ``distill``, ``llama_train``, ``spec``, ``moe``,
``worker_moe`` and ``phase_s`` lines, the ``kernels`` line, the card's
name and power limit, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the repository
beside it, it exits non-zero and prints no result. Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

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
# slot lengths of the edge case: one past the cache, one empty
EDGE_LENS = (4096, 0, 64, 65, 700, 2047, 1500, 333)
# the other inputs of the second-call check: other lengths, one empty
OTHER_LENS = (2048, 5, 129, 1000, 0, 77, 1024, 9)
# launches that must give the same bits
REPEATS = 20


def decode_inputs(kind: str, int8: bool, lens, seed: int, ps: int = 64):
    """Kernel inputs at the 8B decode shape (H=32, KV=8, D=128, B=8):
    paged, (q, k, v, table, kv_len) over a shuffled table of a
    2048-position span; slots, (q, k, v, kv_len) over a 2048-position
    cache read in place."""
    import torch
    from dcos_commons_tpu_torch.ops.quant import quantize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, kv, d, span = 8, 32, 8, 128, 2048
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    if kind == "paged":
        mp = span // ps
        pages = b * mp + 1
        shape = (pages, ps, kv, d)
    else:
        shape = (b, span, kv, d)
    k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    if int8:
        k, v = quantize(k, axis=-1), quantize(v, axis=-1)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    if kind == "slots":
        return q, k, v, kv_len
    perm = torch.randperm(pages - 1, generator=g, device=dev)
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    return q, k, v, table, kv_len


def decode_check(name: str, got, want, lens) -> float:
    """Max abs error of a decode output against its plain version; raises
    outside KERNEL_RTOL/KERNEL_ATOL, on a non-finite value, or on a
    stream with no live position whose output is not exactly 0."""
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    dead = [i for i, n in enumerate(lens) if n <= 0]
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()) \
            or any(bool((got[i] != 0).any()) for i in dead):
        raise RuntimeError(f"{name}: {int(bad.sum())} elements off (max abs "
                           f"err {float(err.max()):.3e}), dead streams "
                           f"{dead}")
    return float(err.max())


def decode_repeat_check(name: str, run, args, other_args, plain) -> None:
    """The second-call and determinism checks: a call on other inputs
    (other lengths, one stream empty) is right, the next call on the first
    inputs gives the first call's bits, and so do REPEATS more."""
    first = run(*args)
    other = run(*other_args)
    decode_check(f"{name} second call", other, plain(*other_args),
                 OTHER_LENS)
    for i in range(REPEATS + 1):
        if not bool((run(*args) == first).all()):
            raise RuntimeError(f"{name}: launch {i + 2} on the same inputs "
                               "differs from the first")


def flash_decode_case(ps: int, int8: bool, flush, run=None,
                      plain: bool = True) -> dict:
    """Kernel 1 vs its plain version at the 8B decode shape: ragged
    streams over a shuffled page table; ``run(q, k, v, table, kv_len)``
    defaults to the wrapper's launch (another version of the source can
    stand in), ``plain`` False skips timing the plain version."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.models.llama import _gather_pages
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    b, h, kv, d, mp = 8, 32, 8, 128, 2048 // ps
    q, k, v, table, kv_len = decode_inputs("paged", int8, KV_LENS,
                                           SEED + ps + int8, ps)
    run = run or (lambda *a: fd._launch_paged(*a, d ** -0.5))
    name = f"flash_decode_paged ps={ps} int8={int8}"
    got = run(q, k, v, table, kv_len)
    want = fd.flash_decode_paged_reference(q, k, v, table, kv_len)
    torch.cuda.synchronize()
    max_err = decode_check(name, got, want, KV_LENS)
    decode_repeat_check(
        name, run, (q, k, v, table, kv_len),
        decode_inputs("paged", int8, OTHER_LENS, SEED + 100 + ps, ps),
        fd.flash_decode_paged_reference)

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
    ms = timed_ms(lambda: run(q, k, v, table, kv_len), iters, flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_paged_reference(
        q, k, v, table, kv_len), 10, flush) if plain else None
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(n, span) for n in KV_LENS)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * mp * 4 + b * 4
    out = {"page_size": ps, "pages": "int8" if int8 else "bf16",
           "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_err": lib_err,
           "bitwise_equal_launches": REPEATS + 2, "second_call": "ok",
           **bound(kv_bytes + io_bytes, 4 * live * h * d)}
    out["bound_share"] = out["bound_ms"] / ms
    return out


def slot_decode_case(int8: bool, kv_lens, flush, run=None,
                     plain: bool = True) -> dict:
    """Kernel 2 vs its plain version at the 8B slot shape: B=8 slots of a
    2048-position cache read in place; ``run(q, k, v, kv_len)`` and
    ``plain`` as for ``flash_decode_case``."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.ops.quant import dequantize

    dev = torch.device("cuda")
    b, h, kv, d, s = 8, 32, 8, 128, 2048
    q, k, v, kv_len = decode_inputs("slots", int8, kv_lens, SEED + 7 + int8)
    run = run or (lambda *a: fd._launch_slots(*a, d ** -0.5))
    name = f"flash_decode int8={int8} lens={kv_lens}"
    got = run(q, k, v, kv_len)
    want = fd.flash_decode_reference(q, k, v, kv_len)
    torch.cuda.synchronize()
    max_err = decode_check(name, got, want, kv_lens)
    decode_repeat_check(name, run, (q, k, v, kv_len),
                        decode_inputs("slots", int8, OTHER_LENS, SEED + 107),
                        fd.flash_decode_reference)

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
    iters = 50
    ms = timed_ms(lambda: run(q, k, v, kv_len), iters, flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_reference(q, k, v, kv_len),
                        10, flush) if plain else None
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(max(n, 0), s) for n in kv_lens)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * 4
    out = {"cache": "int8" if int8 else "bf16", "kv_len": list(kv_lens),
           "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_err": lib_err,
           "bitwise_equal_launches": REPEATS + 2, "second_call": "ok",
           **bound(kv_bytes + io_bytes, 4 * live * h * d)}
    out["bound_share"] = out["bound_ms"] / ms
    return out


# the decode cases of phase 2, the main path's first: (page size, int8)
PAGED_CASES = ((64, False), (64, True), (128, False), (128, True),
               (16, False))
SLOT_CASES = ((False, KV_LENS), (True, KV_LENS), (True, EDGE_LENS),
              (False, EDGE_LENS))


# (name, B, S, H, KV, D): causal, q_offset 0; the first is the main path
FA_SHAPES = (("llama_400m_train", 16, 511, 12, 6, 128),
             ("llama3_8b_heads", 2, 2048, 32, 8, 128),
             ("llama3_8b_distill", 32, 256, 32, 8, 128))
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
    cases = [flash_decode_case(ps, int8, flush) for ps, int8 in PAGED_CASES]
    for c in cases:
        log(f"[kernel] flash_decode_paged {json.dumps(c)}")
    slot_cases = [slot_decode_case(int8, lens, flush)
                  for int8, lens in SLOT_CASES]
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


def serve_queue(v: int) -> list:
    """Phase 3's 12 requests from the seed: 64-1,500 prompt tokens, 32
    new; two share a 319-token prefix: 4 full radix pages of 64 (the
    lookup hit) plus 63 tokens of the fifth (the boundary COW)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    base = _prompt(rng, 320, v)
    alt = (base[319] + 1) % v
    lens = (64, 1500, 300, 777, 128, 1024, 95, 640, 1200, 411)
    queue = [{"prompt": _prompt(rng, n, v), "max_new": 32,
              "request_id": f"r{i}"} for i, n in enumerate(lens)]
    queue.insert(2, {"prompt": base + _prompt(rng, 380, v), "max_new": 32,
                     "request_id": "prefix-a"})
    queue.append({"prompt": base[:319] + [alt] + _prompt(rng, 200, v),
                  "max_new": 32, "request_id": "prefix-b"})
    return queue


def drain_timed(srv, queue) -> tuple:
    """Phase 3's drive: the first 6 requests at decode window 1, the rest
    at 8, submitting as streams free up. Returns (wall s, {request:
    seconds from its run's start to its first token})."""
    runs = [(queue[:6], 1), (queue[6:], 8)]     # (requests, decode window)
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
    return time.perf_counter() - t_start, ttft


def steady_streams(srv) -> None:
    """Reset ``srv`` and prefill 8 streams (1-1,500 prompt tokens; their
    max_new outlasts the 67 steps the longest takes to prefill), all
    decoding after."""
    import numpy as np
    srv.reset()
    rng = np.random.default_rng(SEED + 1)
    srv.submit_many([{"prompt": _prompt(rng, n, srv.cfg.vocab_size),
                      "max_new": 200, "request_id": i} for i, n in enumerate(
                          (1, 63, 64, 65, 700, 1500, 1300, 333))])
    while srv._prefill_q or srv._pending_first:
        srv.step()
    if len(srv._active()) != 8:
        raise RuntimeError(f"expected 8 decoding streams, got "
                           f"{srv._active()}")


def phase_serve(card: str) -> dict:
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.parallel import aot

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] init 8B params in {time.perf_counter() - t0:.1f} s")
    v = cfg.vocab_size
    queue = serve_queue(v)

    cache = aot.CompileCache()
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, compile_cache=cache,
                              device=dev)
    warm = srv.warmup()
    log(f"[serve] warmup {warm}")
    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode_paged.launches = 0
    wall, ttft = drain_timed(srv, queue)
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
    run_graphs = _graph_line(srv)
    log(f"[serve] {len(out)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"{launches} kernel launches, stats {stats}, graphs {run_graphs}")

    # one step, kernel vs dense gather, on the live pool of 8 prefilled
    # streams, then the graphed windows against the eager loop, twice:
    # each round after a reset, the second replaying the first's graphs
    steady = []
    for round_ in range(2):
        steady_streams(srv)
        active = srv._active()
        if round_ == 0:
            mp = srv._window_mp(active, 1)
            tbl = torch.tensor(srv._decode_tables()[:, :mp], device=dev)
            logits = {}
            for mode in ("flash", "dense"):
                pool = {side: p.clone() for side, p in srv.pool.items()}
                logits[mode], _ = llama.decode_step_paged(
                    dataclasses.replace(cfg, decode_attn=mode), params,
                    pool, tbl, srv.lengths, srv.cur_tok, rope=srv._rope)
                del pool
            diff, decided = _kernel_vs_dense(logits["flash"],
                                             logits["dense"])
        steady.append(_graph_vs_eager(srv))
    steady = {"after_reset": steady[0], "after_reset_replayed": steady[1],
              "graph_step_ms": steady[1]["graph_step_ms"],
              "eager_step_ms": steady[1]["eager_step_ms"]}
    # a second engine of the same key: a namespace hit, its own captures
    second = serving.PagedServer(cfg, params, slots=8, page_size=64,
                                 prefill_chunk=64, compile_cache=cache,
                                 device=dev)
    second_warm = second.warmup()
    second_line = {"warmup_s": second_warm, "cache": cache.stats(),
                   "shares_rope": second._rope is srv._rope,
                   "graphs": _graph_line(second)}
    # after the workspace grew: the width-1 window graph that warmup()
    # captured with the smallest workspace replays on a short stream and
    # gives the tokens of the second engine, whose graph never saw a
    # growth
    srv.reset()
    short = [{"prompt": _prompt(np.random.default_rng(SEED + 5), 5, v),
              "max_new": 16, "request_id": "short"}]
    got, want = (e.drain([dict(r) for r in short], decode_window=1)
                 for e in (srv, second))
    if got != want:
        raise RuntimeError(f"width-1 window after the workspace grew: "
                           f"{got} vs a fresh engine's {want}")
    del second
    log(f"[serve] steady B=8 {steady}, second engine {second_line}")
    ttfts = sorted(ttft.values())
    return {"serving": {
        "model": "llama3_8b", "max_seq": cfg.max_seq, "layers": cfg.n_layers,
        "dtype": "bf16", "slots": 8, "page_size": 64, "prefill_chunk": 64,
        "requests": len(out), "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "decode_tok_s_b8": 8 / steady["graph_step_ms"] * 1e3,
        "decode_step_ms_b8": steady["graph_step_ms"],
        "steady_b8_window8": steady, "warmup_s": warm,
        "graphs_after_requests": run_graphs, "graphs": _graph_line(srv),
        "second_engine": second_line,
        "peak_mem_gb": peak_gb, "page_stats": stats,
        "flash_vs_dense_max_abs_logit": diff,
        "flash_vs_dense_argmax_decided": int(decided.sum()),
        "card": card}}, launches, params, {"queue": queue, "out": dict(out)}


# windows of 8 steps timed each way from one snapshot of 8 live streams
STEADY_WINDOWS, STEADY_K = 6, 8


def _graph_line(srv) -> dict:
    g = srv.graph_stats()
    return {"graphs": g["graphs"], "capture_s": g["capture_s"],
            "pool_mb": g["pool_bytes"] / 2 ** 20,
            "keys": [list(k) if isinstance(k, tuple) else k
                     for k in g["keys"]]}


def _kv_of(srv):
    return srv.pool if hasattr(srv, "pool") else srv.cache


def eager_loop(srv, k: int):
    """The eager model-function loop driven by hand, from a snapshot of a
    live engine ``srv``: the engines' decode path before CUDA graphs (the
    mask and the paged table built per window, ``decode_step_paged`` /
    ``decode_step_slots`` plus greedy select per step, one host transfer
    a window), on clones of its K/V, lengths and tokens. Returns
    ``(window, state)``: each ``window()`` decodes ``k`` steps of the
    streams active at the snapshot and returns their tokens on the host
    [k, slots]; ``state`` holds the clones (``kv``, ``ln``, ``tok``)."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops.quant import QTensor

    paged = isinstance(srv, serving.PagedServer)
    dev = srv.device
    kv = {s: (QTensor(x.q.clone(), x.s.clone()) if isinstance(x, QTensor)
              else x.clone()) for s, x in _kv_of(srv).items()}
    active = srv._active()
    tables = srv._decode_tables() if paged else None
    # the host mirror of the longest stream, as the engine keeps it
    state = {"kv": kv, "ln": srv.lengths.clone(), "tok": srv.cur_tok.clone(),
             "top": max(srv.requests[i].prompt_len
                        + len(srv.requests[i].tokens) for i in active)}

    def window():
        ln, tok = state["ln"], state["tok"]
        mask = torch.zeros((srv.slots,), dtype=torch.bool, device=dev)
        mask[active] = True
        if paged:
            mp = min(srv.pages_per_stream,
                     (state["top"] + k - 2) // srv.page_size + 1)
            tbl = torch.tensor(tables[:, :mp], device=dev)
        out = []
        for _ in range(k):
            if paged:
                logits, _ = llama.decode_step_paged(
                    srv.cfg, srv.params, kv, tbl, ln, tok, rope=srv._rope,
                    ffn_override=srv._ffn)
            else:
                logits, _ = llama.decode_step_slots(
                    srv.cfg, srv.params, kv, ln, tok, rope=srv._rope)
            nxt = torch.where(mask, torch.argmax(logits, dim=-1).to(
                torch.int32), tok)
            ln = torch.where(mask, ln + 1, ln)
            tok = nxt
            out.append(nxt)
        state.update(ln=ln, tok=tok, top=state["top"] + k)
        return torch.stack(out).cpu().numpy()

    return window, state


def _graph_vs_eager(srv, windows=STEADY_WINDOWS, k=STEADY_K) -> dict:
    """From one snapshot of a live engine (8 decoding streams): ``windows``
    windows of ``k`` steps through :func:`eager_loop`, then through
    ``step_many(k)``, which replays the engine's graphs (a width not seen
    yet is captured on the way). Each window is timed unprofiled on the
    host clock through its host transfer; the step time is the median
    window's over ``k``. Raises unless both give the same tokens and
    lengths and write bitwise the same K/V."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.ops.quant import QTensor

    active = srv._active()
    window, state = eager_loop(srv, k)
    eager_ms, eager = [], []
    torch.cuda.synchronize()
    for _ in range(windows):
        t0 = time.perf_counter()
        eager.append(window())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    kv, ln, tok = state["kv"], state["ln"], state["tok"]
    captured_before = len(srv._graphs)
    graph_ms, graphed = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = srv.step_many(k)
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        graphed.append(out)
    want = np.concatenate(eager)
    problems = []
    for i in active:
        got = [t for out in graphed for t in out[i]]
        if got != want[:, i].tolist():
            problems.append(f"stream {i}: graphed {got[:8]}... vs eager "
                            f"{want[:, i].tolist()[:8]}...")
    if not (torch.equal(srv.lengths, ln) and torch.equal(srv.cur_tok, tok)):
        problems.append(f"lengths {srv.lengths.tolist()} vs eager "
                        f"{ln.tolist()}")
    bitwise, max_diff = True, 0.0
    for side in ("k", "v"):
        a, b = _kv_of(srv)[side], kv[side]
        pairs = [(a.q, b.q), (a.s, b.s)] if isinstance(a, QTensor) \
            else [(a, b)]
        for x, y in pairs:
            if not torch.equal(x, y):
                bitwise = False
                max_diff = max(max_diff, float((x.float() - y.float())
                                               .abs().max()))
    del kv
    if not bitwise:
        problems.append(f"K/V written differ, max abs {max_diff}")
    if problems:
        raise RuntimeError("graphed windows vs the eager loop: "
                           + "; ".join(problems[:4]))
    med = sorted(graph_ms)[len(graph_ms) // 2]
    med_eager = sorted(eager_ms)[len(eager_ms) // 2]
    return {"batch": len(active), "windows": windows, "k": k,
            "graph_step_ms": med / k, "eager_step_ms": med_eager / k,
            "graph_window_ms": graph_ms, "eager_window_ms": eager_ms,
            "speedup": med_eager / med,
            "graphs_captured_here": len(srv._graphs) - captured_before,
            "tokens_equal": True, "kv_bitwise_equal": bitwise,
            "kv_max_abs_diff": max_diff}


def _kernel_vs_dense(lf, ld, atol=LOGIT_ATOL):
    """Max |logit difference| of a decode step through the kernel vs the
    dense read, and how many rows have a decided argmax (top two apart by
    more than the tolerance); raises if they disagree."""
    import torch
    diff = float((lf - ld).abs().max())
    top2 = torch.topk(ld, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > atol
    agree = (lf.argmax(-1) == ld.argmax(-1)) | ~decided
    if diff > atol or not bool(agree.all()) \
            or not bool(torch.isfinite(lf).all()):
        raise RuntimeError(f"decode step kernel vs dense: max |dlogit| "
                           f"{diff:.4f} (tol {atol}), argmax agree "
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

    # after a reset (the front door's window graph stays captured): one
    # step through the kernel vs the dense read on a live cache of 8
    # slots, then the graphed windows against the eager loop
    srv.reset()
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
    steady = _graph_vs_eager(srv)
    log(f"[slots] steady B=8 {steady}")
    return {"serving_slots": {
        "model": "llama3_8b", "max_seq": cfg.max_seq, "layers": cfg.n_layers,
        "dtype": "bf16", "engine": "SlotServer", "slots": 8,
        "front_door": "ServingFrontend", "decode_window": 8,
        "requests": len(replies), "streamed": len(STREAMED),
        "tokens_out": n_tok, "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "decode_tok_s_b8": 8 / steady["graph_step_ms"] * 1e3,
        "decode_step_ms_b8": steady["graph_step_ms"],
        "steady_b8_window8": steady, "graphs": _graph_line(srv),
        "peak_mem_gb": peak_gb, "launches": launches,
        "solo_generate_chunked": {"batch": 1, "chunk": 16, "steps": 32},
        "flash_vs_dense_max_abs_logit": diff,
        "flash_vs_dense_argmax_decided": int(decided.sum()),
        "card": card}}, launches


# --------------------------------------------------------------- phase 6

WORKER_LENS = (64, 1500, 300, 777, 128, 1024, 95, 640)
WORKER_STREAMED = (3,)
WORKER_ARGS = ("llama", "--preset", "8b", "--serve", "--slots", "8",
               "--serve-port", "0", "--serve-interval", "2")
# the worker's engines: (line name, extra flags, engine, the kernels its
# run must launch)
WORKER_ENGINES = (
    ("worker", (), "SlotServer", ("flash_decode", "flash_attention_fwd")),
    ("worker_paged", ("--pages", "64"), "PagedServer",
     ("flash_decode_paged",)),
)
WORKER_BOOT_S = 600
WORKER_VOCAB = 128256           # Llama-3-8B's


def phase_worker(card: str, name: str, extra, engine: str, kernels,
                 expect=(), forbid=("paged_fallback",)):
    """The process the scheduler starts: the port's worker
    (``python -m dcos_commons_tpu_torch.frameworks.worker`` with
    ``WORKER_ARGS`` and ``extra``, serving with ``engine``) on the card.
    Reads its ``serving`` event (after each event of ``expect``; an event
    of ``forbid`` or an ``error`` fails the phase), sends 8 concurrent
    ``POST /v1/generate`` (64-1,500 prompt tokens, 32 new, one streamed),
    checks ``/v1/healthz`` and ``/v1/stats``, waits for a heartbeat that
    has seen them, and ends it with SIGTERM. Its kernel launches are the
    worker's own counts while it served: the heartbeat's less those in
    its ``serving`` event. Returns (line, launches, replies, events)."""
    import queue
    import signal

    root = Path(__file__).resolve().parent
    cwd = root / "build" / "worker_smoke"
    cwd.mkdir(parents=True, exist_ok=True)
    args = [*WORKER_ARGS, *extra]
    cmd = [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
           *args]
    env = dict(os.environ, PYTHONPATH=str(root))
    v = WORKER_VOCAB
    bodies = worker_bodies()
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    events = []

    def pump():
        for raw in proc.stdout:
            lines.put(raw)

    threading.Thread(target=pump, daemon=True).start()

    def event(name, timeout, where=lambda e: True):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            try:
                raw = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None and lines.empty():
                    break
                continue
            if raw.startswith("{"):
                e = json.loads(raw)
                events.append(e)
                if e.get("event") == "error" or e.get("event") in forbid:
                    raise RuntimeError(f"worker: {e}")
                if e.get("event") == name and where(e):
                    return e
        raise RuntimeError(f"worker: no {name} event within {timeout} s "
                           f"(exit {proc.poll()})")

    try:
        for name_ in expect:
            event(name_, WORKER_BOOT_S)
        serving = event("serving", WORKER_BOOT_S)
        boot_s = time.perf_counter() - t_start
        port = serving["port"]
        replies, errors = [None] * len(bodies), []

        def hit(i):
            try:
                replies[i] = _http_generate(port, bodies[i])
            except Exception as e:          # reported below, all at once
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        health = _http_get(port, "/v1/healthz")
        stats = _http_get(port, "/v1/stats")
        beat = event("heartbeat", 60,
                     lambda e: e.get("requests", 0) >= len(bodies))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    problems = list(errors)
    for i, r in enumerate(replies):
        toks = (r or {}).get("tokens", [])
        if len(toks) != 32 or not all(0 <= t < v for t in toks):
            problems.append(f"request {i}: {len(toks)} tokens")
    if stats["requests"] != len(bodies) or stats["tokens"] != 32 * len(
            bodies):
        problems.append(f"/v1/stats counts {stats['requests']} requests, "
                        f"{stats['tokens']} tokens")
    if not health["ok"] or health["free"] != 8:
        problems.append(f"/v1/healthz {health}")
    at_serving = serving.get("launches", {})
    launches = {k: beat.get("launches", {}).get(k, 0) - at_serving.get(k, 0)
                for k in kernels}
    for k, n in launches.items():
        if n < 1:
            problems.append(f"{k} never launched while the worker served")
    if ("paged" in serving) != (engine == "PagedServer"):
        problems.append(f"the worker served another engine: {serving}")
    if rc != -signal.SIGTERM:
        problems.append(f"worker exited {rc} on SIGTERM")
    if problems:
        raise RuntimeError(f"{name} phase: " + "; ".join(problems))
    n_tok = sum(len(r["tokens"]) for r in replies)
    line = {name: {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(args),
        "model": "llama3_8b", "max_seq": 2048, "dtype": "bf16",
        "engine": engine, "slots": 8, "decode_window": 8,
        "boot_to_serving_s": boot_s, "cold_start": serving["cold_start"],
        "solo_tokens_per_sec": serving["tokens_per_sec"],
        "requests": len(replies), "streamed": len(WORKER_STREAMED),
        "prompt_lens": list(WORKER_LENS), "tokens_out": n_tok,
        "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "peak_mem_gb": beat.get("peak_mem_gb"), "graphs": beat.get("graphs"),
        "launches": launches, "exit_on_sigterm": rc,
        "stats_window": stats["window"],
        **({"paged": beat["paged"]} if "paged" in beat else {}),
        "card": card}}
    log(f"[{name}] {line}")
    return line, launches, [r["tokens"] for r in replies], events


def worker_bodies():
    """The workers' 8 requests, from the seed."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    return [{"prompt": _prompt(rng, n, WORKER_VOCAB), "max_new": 32,
             "stream": i in WORKER_STREAMED}
            for i, n in enumerate(WORKER_LENS)]


# --------------------------------------------------------------- phase 7

# the worker's DRAFT_LAYERS / DRAFT_K defaults
DRAFT_LAYERS, SPEC_K = 1, 4
# requests of phase 3 the self-draft serves (the last one after the
# others, adopting prefix-a's radix pages), and its eager windows whose
# rejections are held to the near-tie rule
SELF_DRAFT_REQUESTS = ("r0", "r1", "prefix-a", "prefix-b")
SELF_DRAFT_WINDOWS = 8
# the least share of self-draft proposals each served drain must accept:
# a sound self-draft accepted 96 of 108 on the H100 (it rejects only at
# bf16 near-ties, each costing up to k-1 proposals of a one-stream
# drain's few dozen), a draft that sees the wrong cache about none
SELF_DRAFT_ACCEPT_FLOOR = 0.5
# a spec stream may leave the solo stream only where the solo's logit of
# the spec's token is within this of its top logit (the verify reads the
# dense gather, solo decode kernel 1, in another reduction order): the
# kernel-vs-dense tolerance of one decode step
NEAR_TIE_ATOL = LOGIT_ATOL


def _teacher_gaps(cfg, params, rope, prompt, toks, ffn=None) -> list:
    """For each token of ``toks``, the target's top logit less its logit
    of that token at its position: one causal forward over ``prompt +
    toks[:-1]`` (the stream fed back as its own prefix). With ``ffn`` (an
    MoE model's ``make_moe_ffn``) the forward is one ``extend_step`` from
    position 0, the sequence one dispatch group."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.quant import qmm
    dev = rope.device
    seq = torch.tensor([prompt + toks[:-1]], dtype=torch.int32, device=dev)
    if ffn is None:
        x, _, _ = llama.prefill_trunk(cfg, params, seq, rope)
        logits = qmm(x[0, len(prompt) - 1:], params["lm_head"]).float()
    else:
        cache = llama.init_kv_cache(cfg, 1, cfg.max_seq, device=dev)
        logits, _ = llama.extend_step(cfg, params, cache, seq, 0, rope=rope,
                                      ffn_override=ffn)
        logits = logits[0, len(prompt) - 1:]
        del cache
    t = torch.tensor(toks, dtype=torch.int64, device=dev)[:, None]
    gaps = logits.max(dim=-1).values - logits.gather(1, t)[:, 0]
    return gaps.tolist()


def stream_check(name, got, want, prompts, cfg, params, ffn=None) -> list:
    """Each stream of ``got`` teacher-forced through the target: every
    token must be within ``NEAR_TIE_ATOL`` of the top logit at its
    position, given the stream's own earlier tokens, so a stream may
    leave the solo ``want`` only at a near-tie and is held to the target
    after it too. Returns where each stream first leaves solo (with the
    gap there); raises on any token away from a near-tie."""
    from dcos_commons_tpu_torch.ops.rotary import rope_frequencies
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=params["norm"].device)
    divergences, problems, checked, worst = [], [], 0, 0.0
    for rid, w in want.items():
        g = got.get(rid)
        if g is None or len(g) != len(w):
            problems.append(f"{rid}: {None if g is None else len(g)} tokens "
                            f"against {len(w)}")
            continue
        gaps = _teacher_gaps(cfg, params, rope, prompts[rid], g, ffn)
        checked, worst = checked + len(g), max(worst, *gaps)
        problems += [f"{rid}: token {j} is {g[j]}, the target's top logit "
                     f"{gap:.4f} above it" for j, gap in enumerate(gaps)
                     if gap > NEAR_TIE_ATOL]
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            divergences.append({"stream": rid, "at": j, "gap": gaps[j]})
    if problems:
        raise RuntimeError(f"{name}: {len(problems)} tokens away from a "
                           "near-tie of the target: " + "; ".join(
                               problems[:4]))
    log(f"[check] {name}: {checked} tokens teacher-forced, largest gap "
        f"{worst}")
    return divergences


def spec_eager_loop(srv):
    """The speculative window's eager model-function loop driven by hand,
    from a snapshot of an armed ``PagedServer`` ``srv`` with every
    decoding stream active: k greedy ``decode_step_slots`` over the draft
    cache, ``verify_step_paged`` over the pool (the table built per
    window), the acceptance counted on the host, on clones of the pool,
    the draft cache, the lengths and the tokens. Returns ``(window,
    state)``: each ``window()`` returns the window's target tokens
    [slots, k] and ``n_emit`` [slots] on the host."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def clone(kv):
        return {s: (QTensor(x.q.clone(), x.s.clone())
                    if isinstance(x, QTensor) else x.clone())
                for s, x in kv.items()}

    dev = srv.device
    cfg_d, params_d = srv._draft
    k = srv.draft_k
    active = srv._active()
    tables = srv._decode_tables()
    mask = torch.zeros((srv.slots,), dtype=torch.bool, device=dev)
    mask[active] = True
    state = {"pool": clone(srv.pool), "draft": clone(srv._draft_cache),
             "ln": srv.lengths.clone(), "tok": srv.cur_tok.clone()}

    def window():
        ln, tok = state["ln"], state["tok"]
        top = int(ln[active].max()) + 1
        mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
        tbl = torch.tensor(tables[:, :mp], device=dev)
        cur, drafted = tok, []
        for j in range(k):
            lg, _ = llama.decode_step_slots(cfg_d, params_d, state["draft"],
                                            ln + j, cur, rope=srv._draft_rope)
            cur = torch.where(mask, torch.argmax(lg, dim=-1).to(torch.int32),
                              cur)
            drafted.append(cur)
        drafted = torch.stack(drafted[:k - 1], dim=1)
        logits, _ = llama.verify_step_paged(
            srv.cfg, srv.params, state["pool"], tbl, ln,
            torch.cat([tok[:, None], drafted], dim=1), rope=srv._rope)
        state["logits"] = logits
        tgt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        d = state["drafted"] = drafted.cpu().numpy()
        n = np.zeros((srv.slots,), np.int32)
        new_tok = tok.cpu().numpy().copy()
        for i in active:
            a = 0
            while a < k - 1 and d[i, a] == tgt[i, a]:
                a += 1
            n[i] = a + 1
            new_tok[i] = tgt[i, a]
        state["ln"] = ln + torch.from_numpy(n).to(dev)
        state["tok"] = torch.from_numpy(new_tok).to(dev)
        return tgt, n

    return window, state


def verify_vs_steps(srv, atol=LOGIT_ATOL) -> float:
    """The armed engine's K-wide verify (dense gather) against k
    successive paged decode steps through kernel 1, on clones of its
    live pool: the window is the steps' own greedy tokens, and each
    position's logits must agree within ``atol`` (``_kernel_vs_dense``)
    for the active streams. Returns the max |logit difference|."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def clone(kv):
        return {s: (QTensor(x.q.clone(), x.s.clone())
                    if isinstance(x, QTensor) else x.clone())
                for s, x in kv.items()}

    k = srv.draft_k
    active = srv._active()
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    top = int(ln[active].max()) + 1
    mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=srv.device)
    pool = clone(srv.pool)
    steps, window, cur = [], [tok], tok
    for j in range(k):
        lg, _ = llama.decode_step_paged(srv.cfg, srv.params, pool, tbl,
                                        ln + j, cur, rope=srv._rope)
        steps.append(lg)
        cur = torch.argmax(lg, dim=-1).to(torch.int32)
        window.append(cur)
    del pool
    pool = clone(srv.pool)
    verify, _ = llama.verify_step_paged(
        srv.cfg, srv.params, pool, tbl, ln, torch.stack(window[:k], dim=1),
        rope=srv._rope)
    del pool
    worst = 0.0
    for j in range(k):
        diff, _ = _kernel_vs_dense(steps[j][active], verify[active, j],
                                   atol=atol)
        worst = max(worst, diff)
    return worst


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn`` captured as a CUDA graph, over ``iters``
    replays timed with CUDA events."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                            # lazy init
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spec_split(srv) -> dict:
    """A spec window's device time by part, from the armed engine's live
    state (every decoding stream active): the k draft steps, the K-wide
    verify, the verify's page gather and dense attention alone (every
    layer's, at the window's table width) and the acceptance, each
    captured as its own CUDA graph on clones of the state and timed over
    replays (:func:`graph_ms`)."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.attention import gqa_attention

    cfg, k = srv.cfg, srv.draft_k
    cfg_d, params_d = srv._draft
    active = srv._active()
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    mask = torch.zeros((srv.slots,), dtype=torch.bool, device=srv.device)
    mask[active] = True
    top = int(ln[active].max()) + 1
    mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=srv.device)
    pool = {s: t.clone() for s, t in srv.pool.items()}
    draft = {s: t.clone() for s, t in srv._draft_cache.items()}
    window = torch.cat([tok[:, None]] * k, dim=1)
    logits = torch.zeros((srv.slots, k, cfg.vocab_size), device=srv.device)

    def draft_steps():
        cur = tok
        for j in range(k):
            lg, _ = llama.decode_step_slots(cfg_d, params_d, draft, ln + j,
                                            cur, rope=srv._draft_rope)
            cur = torch.where(mask, torch.argmax(lg, dim=-1).to(torch.int32),
                              cur)

    def verify():
        llama.verify_step_paged(cfg, srv.params, pool, tbl, ln, window,
                                rope=srv._rope)

    q = torch.randn((srv.slots, k, cfg.n_heads, cfg.head_dim),
                    device=srv.device).to(cfg.dtype)

    def attention():
        for i in range(cfg.n_layers):
            kr = llama._gather_pages(pool["k"][i], tbl, cfg.dtype)
            vr = llama._gather_pages(pool["v"][i], tbl, cfg.dtype)
            gqa_attention(q, kr, vr, causal=True, q_offset=ln,
                          kv_len=ln + k)

    def accept():
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)
        agree = torch.cumprod((window[:, 1:] == tgt[:, :k - 1]).to(
            torch.int32), dim=1)
        n = torch.where(mask, agree.sum(dim=1).to(torch.int32) + 1,
                        torch.zeros_like(ln))
        torch.gather(tgt, 1, (n - 1).clamp(min=0).long()[:, None])

    out = {"draft_steps_ms": graph_ms(draft_steps),
           "verify_ms": graph_ms(verify),
           "verify_gather_attention_ms": graph_ms(attention),
           "accept_ms": graph_ms(accept)}
    out["parts_ms"] = (out["draft_steps_ms"] + out["verify_ms"]
                       + out["accept_ms"])
    out["verify_share"] = out["verify_ms"] / out["parts_ms"]
    return {"k": k, "draft_layers": cfg_d.n_layers, "batch": len(active),
            "table_width": mp, "positions_max": top, **out}


def self_draft_rejections(srv, windows: int) -> list:
    """From a snapshot of an engine armed with the self-draft, ``windows``
    windows of :func:`spec_eager_loop`: for every rejected proposal, the
    verify's top logit less its logit of the proposal. The proposals are
    the target's own greedy tokens reached by another path (kernel 2 over
    the draft cache, against the verify's dense gather), so each gap must
    be within ``NEAR_TIE_ATOL``; raises otherwise."""
    window, state = spec_eager_loop(srv)
    k, out = srv.draft_k, []
    for _ in range(windows):
        _, n = window()
        for i in srv._active():
            a = int(n[i]) - 1
            if a < k - 1:
                row = state["logits"][i, a]
                out.append(float(row.max() - row[int(state["drafted"][i, a])]))
    del state
    bad = [g for g in out if g > NEAR_TIE_ATOL]
    if bad:
        raise RuntimeError(f"self-draft: {len(bad)} of {len(out)} rejections "
                           f"away from a near-tie (verify gaps {bad[:4]})")
    return out


def _live_rows_equal(srv, state) -> tuple:
    """(pool rows equal, draft rows equal): each active stream's rows
    below its length, read through its table in the pool and in place in
    the draft cache, engine against the eager loop's clones, bitwise."""
    import torch
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def parts(x):
        return (x.q, x.s) if isinstance(x, QTensor) else (x,)

    pool_eq = draft_eq = True
    ps = srv.page_size
    for i in srv._active():
        n = int(srv.lengths[i])
        pages = torch.tensor(srv._tables[i, :-(-n // ps)],
                             device=srv.device, dtype=torch.long)
        for side in ("k", "v"):
            for a, b in zip(parts(srv.pool[side]), parts(state["pool"][side])):
                ra = a[:, pages].flatten(1, 2)[:, :n]
                rb = b[:, pages].flatten(1, 2)[:, :n]
                pool_eq &= bool(torch.equal(ra, rb))
            a, b = srv._draft_cache[side], state["draft"][side]
            draft_eq &= bool(torch.equal(a[:, i, :n], b[:, i, :n]))
    return pool_eq, draft_eq


def _spec_graph_vs_eager(srv, windows=STEADY_WINDOWS) -> dict:
    """From one snapshot of an armed engine (8 decoding streams):
    ``windows`` spec windows through :func:`spec_eager_loop`, then through
    ``step_many``, which replays the engine's spec graphs (a width not
    seen yet is captured on the way). Each window is timed unprofiled on
    the host clock through its host transfer. Raises unless both give the
    same tokens, ``n_emit`` and lengths and write bitwise the same live
    K/V rows in the pool and the draft cache."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    active = srv._active()
    k = srv.draft_k
    window, state = spec_eager_loop(srv)
    eager_ms, eager = [], []
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    for _ in range(windows):
        t0 = time.perf_counter()
        eager.append(window())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    graph_ms, graphed, per_window = [], [], []
    for _ in range(windows):
        captured, before = len(srv._graphs), fd.flash_decode.launches
        t0 = time.perf_counter()
        out = srv.step_many(k)
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        graphed.append(out)
        if len(srv._graphs) == captured:            # a replay
            per_window.append(fd.flash_decode.launches - before)
    problems = []
    for w, ((tgt, n), out) in enumerate(zip(eager, graphed)):
        for i in active:
            if out.get(i) != tgt[i, :n[i]].tolist():
                problems.append(f"window {w} stream {i}: graphed {out.get(i)}"
                                f" vs eager {tgt[i, :n[i]].tolist()}")
    if not (torch.equal(srv.lengths, state["ln"])
            and torch.equal(srv.cur_tok, state["tok"])):
        problems.append(f"lengths {srv.lengths.tolist()} vs eager "
                        f"{state['ln'].tolist()}")
    pool_eq, draft_eq = _live_rows_equal(srv, state)
    if not (pool_eq and draft_eq):
        problems.append(f"live K/V rows differ: pool {pool_eq}, draft "
                        f"{draft_eq}")
    want_launches = k * srv._draft[0].n_layers
    if not per_window or any(n != want_launches for n in per_window):
        problems.append(f"kernel 2 launches a replayed window {per_window}, "
                        f"expected {want_launches}")
    del state
    if problems:
        raise RuntimeError("graphed spec windows vs the eager loop: "
                           + "; ".join(problems[:4]))
    emitted = [int(n[i]) for _, n in eager for i in active]
    med = sorted(graph_ms)[len(graph_ms) // 2]
    med_eager = sorted(eager_ms)[len(eager_ms) // 2]
    return {"batch": len(active), "windows": windows, "k": k,
            "graph_window_ms": med, "eager_window_ms": med_eager,
            "graph_window_ms_all": graph_ms, "eager_window_ms_all": eager_ms,
            "tokens_per_target_pass": float(np.mean(emitted)),
            "kernel2_launches_per_window": per_window,
            "tokens_equal": True, "n_emit_equal": True,
            "live_kv_bitwise_equal": True}


def _serve_spec(srv, reqs, window=8):
    """Drain ``reqs`` through the armed engine with the kernel counts set
    to 0 just before and read just after: (streams, wall s, launches,
    captures)."""
    import torch
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    counters = {"flash_decode": fd.flash_decode,
                "flash_decode_paged": fd.flash_decode_paged,
                "flash_attention_fwd": fa.flash_attention_fwd}
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    graphs = len(srv._graphs)
    t0 = time.perf_counter()
    out = srv.drain([dict(r) for r in reqs], decode_window=window)
    wall = time.perf_counter() - t0
    return (out, wall, {n: c.launches for n, c in counters.items()},
            len(srv._graphs) - graphs)


def phase_spec(card: str, params, solo) -> tuple:
    """Speculative decoding in process, on phase 3's 8B weights:
    (1) ``PagedServer(slots=8, page_size=64, prefill_chunk=64)`` armed
    with ``truncate_layers(cfg, params, 1)`` at k=4 serves phase 3's 12
    requests, every stream held to phase 3's solo stream (near-tie rule);
    (3) after a reset, 6 spec windows at B=8 graphed and by the eager
    loop; (2) the self-draft (all 32 layers) on 4 of the requests, then
    its rejections held to the near-tie rule
    (:func:`self_draft_rejections`)."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    v = cfg.vocab_size
    queue, want = solo["queue"], solo["out"]
    prompts = {r["request_id"]: r["prompt"] for r in queue}
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, device=dev)
    cfg_d, params_d = llama.truncate_layers(cfg, params, DRAFT_LAYERS)
    t0 = time.perf_counter()
    srv.arm_draft(cfg_d, params_d, k=SPEC_K)
    arm_s = time.perf_counter() - t0
    out, wall, launches, captures = _serve_spec(srv, queue)
    stats = srv.page_stats()
    problems = []
    divergences = stream_check("spec engine (truncated draft)", out, want,
                               prompts, cfg, params)
    if srv.ledger_violations():
        problems.append(f"ledger: {srv.ledger_violations()[:3]}")
    held = sum(srv.radix.held().values()) if srv.radix else 0
    if any(srv._stream_pages) or srv.ledger.in_use() != len(
            srv.radix.held() if srv.radix else ()) or held < 1:
        problems.append(f"pages not back after the drain: {stats}")
    spec = stats["spec"]
    want_k2 = (spec["windows"] + captures) * SPEC_K * DRAFT_LAYERS
    if launches["flash_decode"] != want_k2 or spec["windows"] < 1:
        problems.append(f"kernel 2 launched {launches['flash_decode']} "
                        f"times in {spec['windows']} windows and {captures} "
                        f"captures, expected {want_k2}")
    if launches["flash_attention_fwd"] != len(queue) * DRAFT_LAYERS:
        problems.append(f"kernel 3 launched {launches['flash_attention_fwd']}"
                        f" times for {len(queue)} draft prefills")
    if spec["fallbacks"]:
        problems.append(f"spec fallbacks {spec['fallbacks']}")
    if problems:
        raise RuntimeError("spec phase: " + "; ".join(problems))
    n_tok = sum(len(t) for t in out.values())
    log(f"[spec] {len(out)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"launches {launches}, spec {spec}, divergences {divergences}")

    # (3) graphed vs eager after a reset, replaying part 1's graphs
    srv.reset()
    rng = np.random.default_rng(SEED + 1)
    srv.submit_many([{"prompt": _prompt(rng, n, v), "max_new": 200,
                      "request_id": i} for i, n in enumerate(
                          (1, 63, 64, 65, 700, 1500, 1300, 333))])
    while srv._prefill_q or srv._pending_first:
        srv.step_many(1)
    if len(srv._active()) != 8:
        raise RuntimeError(f"expected 8 decoding streams, got "
                           f"{srv._active()}")
    verify_diff = verify_vs_steps(srv)
    steady = _spec_graph_vs_eager(srv)
    steady["verify_vs_kernel_steps_max_abs_logit"] = verify_diff
    steady["split"] = spec_split(srv)
    log(f"[spec] graphed vs eager {steady}")
    graphs = _graph_line(srv)

    # (2) the self-draft: every layer of the target as its own draft,
    # first on three requests, then on prefix-b alone, whose prompt
    # adopts prefix-a's radix pages (the draft must still see all of it);
    # each drain's acceptance is held to SELF_DRAFT_ACCEPT_FLOOR
    srv.reset()
    cfg_s, params_s = llama.truncate_layers(cfg, params, cfg.n_layers)
    srv.arm_draft(cfg_s, params_s, k=SPEC_K)
    by_id = {r["request_id"]: r for r in queue}
    self_reqs = [by_id[rid] for rid in SELF_DRAFT_REQUESTS]
    out_s, wall_s, launches_s, drains = {}, 0.0, {}, []
    for reqs in (self_reqs[:-1], self_reqs[-1:]):
        before = dict(srv.page_stats())
        out, wall, launches_d, _ = _serve_spec(srv, reqs)
        after = srv.page_stats()
        out_s.update(out)
        wall_s += wall
        for n, c in launches_d.items():
            launches_s[n] = launches_s.get(n, 0) + c
        drains.append({
            "requests": [r["request_id"] for r in reqs],
            "proposed": after["spec"]["proposed"]
            - before["spec"]["proposed"],
            "accepted": after["spec"]["accepted"]
            - before["spec"]["accepted"],
            "prefix_hits": after["prefix_hits"] - before["prefix_hits"]})
    proposed = sum(d["proposed"] for d in drains)
    accepted = sum(d["accepted"] for d in drains)
    self_rate = accepted / max(proposed, 1)
    low = [d for d in drains
           if d["accepted"] < SELF_DRAFT_ACCEPT_FLOOR * d["proposed"]
           or not d["proposed"]]
    if low or drains[-1]["prefix_hits"] < 1:
        raise RuntimeError(f"self-draft: acceptance under "
                           f"{SELF_DRAFT_ACCEPT_FLOOR} or prefix-b adopted "
                           f"no radix page: {drains}")
    div_s = stream_check("spec engine (self-draft)", out_s,
                         {r["request_id"]: want[r["request_id"]]
                          for r in self_reqs}, prompts, cfg, params)
    srv.reset()
    srv.submit_many([{**r, "max_new": 200} for r in self_reqs])
    while srv._prefill_q or srv._pending_first:
        srv.step_many(1)
    gaps = self_draft_rejections(srv, SELF_DRAFT_WINDOWS)
    log(f"[spec] self-draft {len(out_s)} requests in {wall_s:.1f} s, "
        f"accept {self_rate:.3f}, divergences {div_s}, eager rejections' "
        f"verify gaps {gaps}")
    srv.disarm_draft()
    del srv
    return {
        "engine": "PagedServer", "slots": 8, "page_size": 64,
        "prefill_chunk": 64, "k": SPEC_K, "draft_layers": DRAFT_LAYERS,
        "requests": len(out), "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall, "arm_s": arm_s,
        "windows": spec["windows"], "proposed": spec["proposed"],
        "accepted": spec["accepted"], "accept_rate": spec["accept_rate"],
        "fallbacks": spec["fallbacks"],
        "draft_prefill_s": spec["draft_prefill_s"],
        "window_s": spec["window_s"], "captures": captures,
        "launches": launches, "graphs": graphs,
        "near_tie_atol": NEAR_TIE_ATOL, "divergences": divergences,
        "graphed_vs_eager": steady,
        "self_draft": {"requests": len(out_s), "wall_s": wall_s,
                       "proposed": proposed, "accepted": accepted,
                       "accept_rate": self_rate, "launches": launches_s,
                       "accept_floor": SELF_DRAFT_ACCEPT_FLOOR,
                       "drains": drains, "divergences": div_s,
                       "eager_windows": SELF_DRAFT_WINDOWS,
                       "eager_rejections": len(gaps),
                       "eager_rejection_max_gap": max(gaps, default=0.0)},
        "card": card}, launches


def save_spec_draft(params) -> dict:
    """The worker's draft artifact: ``save_draft`` of the 1-layer
    truncated 8B draft under ``build/spec_draft`` (the worker loads it;
    its ``spec_armed`` event says how long that took)."""
    import shutil
    from dcos_commons_tpu_torch.models import llama, speculative

    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    cfg_d, params_d = llama.truncate_layers(cfg, params, DRAFT_LAYERS)
    path = Path(__file__).resolve().parent / "build" / "spec_draft"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    t0 = time.perf_counter()
    step_dir = speculative.save_draft(str(path), 1, cfg_d, params_d,
                                      target_cfg=cfg)
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(step_dir).iterdir())
    return {"path": str(path), "save_s": save_s, "bytes": size}


def phase_spec_worker(card, artifact, solo_replies, params):
    """The worker with ``--spec-decode`` on the artifact: ``spec_armed``
    with one draft layer (a ``spec_fallback`` fails the phase), the
    requests of phase 6, tokens held to the paged worker's solo streams
    (near-tie rule), ``/v1/stats`` with spec windows."""
    from dcos_commons_tpu_torch.models import llama
    extra = ("--pages", "64", "--spec-decode", "true", "--draft-checkpoint",
             artifact["path"], "--draft-k", str(SPEC_K))
    line, launches, replies, events = phase_worker(
        card, "worker_spec", extra, "PagedServer",
        ("flash_decode", "flash_attention_fwd"), expect=("spec_armed",),
        forbid=("paged_fallback", "spec_fallback"))
    armed = next(e for e in events if e["event"] == "spec_armed")
    body = line["worker_spec"]
    problems = []
    if armed["draft_layers"] != DRAFT_LAYERS or armed["k"] != SPEC_K:
        problems.append(f"armed {armed}")
    if not body["stats_window"].get("spec_windows"):
        problems.append(f"/v1/stats shows no spec window: "
                        f"{body['stats_window']}")
    if launches["flash_attention_fwd"] != len(WORKER_LENS) * DRAFT_LAYERS:
        problems.append(f"kernel 3 launched {launches['flash_attention_fwd']}"
                        " times while serving")
    if problems:
        raise RuntimeError("worker_spec phase: " + "; ".join(problems))
    bodies = worker_bodies()
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    divergences = stream_check(
        "worker_spec", dict(enumerate(replies)), dict(enumerate(solo_replies)),
        {i: b["prompt"] for i, b in enumerate(bodies)}, cfg, params)
    body["spec_armed"] = armed
    body["divergences"] = divergences
    return line, launches


# --------------------------------------------------------------- phase 8

# the reference's distill defaults at the 8B preset
DISTILL_BATCH, DISTILL_SEQ, DISTILL_STEPS = 32, 256, 20
DISTILL_ARGS = ("distill", "--preset", "8b", "--draft-layers",
                str(DRAFT_LAYERS), "--batch", str(DISTILL_BATCH), "--seq",
                str(DISTILL_SEQ), "--steps", str(DISTILL_STEPS))
# the reckoning for one step at this shape (PERF.md's distill prediction),
# printed beside the run
DISTILL_STEP_S_PREDICTED = (0.35, 0.5)
DISTILL_PEAK_GB_PREDICTED = 49.0
TRAIN_TIMEOUT_S = 900


def _worker_run(args, cwd, timeout=TRAIN_TIMEOUT_S, on_event=None):
    """``python -m dcos_commons_tpu_torch.frameworks.worker *args`` in
    ``cwd``: (exit code, its JSON events). ``on_event(proc, event)`` sees
    each event as it arrives."""
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
         *args], cwd=cwd, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(root)))
    events = []
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        for raw in proc.stdout:
            if raw.startswith("{"):
                events.append(json.loads(raw))
                if on_event is not None:
                    on_event(proc, events[-1])
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, events


def _one(events, name):
    found = [e for e in events if e.get("event") == name]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} {name} events: {events[-3:]}")
    return found[0]


def phase_distill(card: str) -> tuple:
    """The worker's ``distill --preset 8b`` at the reference's defaults
    (batch 32 x 256 tokens, 1 draft layer, 20 steps after the warm-up)
    as a subprocess: exit 0, finite falling losses, kernels 3-5 launched
    once a layer a step by the run's own counts (32 + 1 forward launches
    a step, 1 of each backward kernel: no attention went dense), the
    checkpoint and the sealed draft saved. Returns (line, launches, the
    artifact's directory)."""
    import math
    import shutil

    out = Path(__file__).resolve().parent / "build" / "distill_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    rc, events = _worker_run([*DISTILL_ARGS, "--out", str(out)], out.parent)
    wall = time.perf_counter() - t0
    problems = [] if rc == 0 else [f"exit {rc}"]
    done = _one(events, "done") if rc == 0 else {}
    saved = _one(events, "draft_saved") if rc == 0 else {}
    traj = done.get("loss_trajectory") or []
    if not traj or not all(math.isfinite(x) for x in traj):
        problems.append(f"losses {traj}")
    elif not done["loss_final"] < done["loss_first"]:
        problems.append(f"loss did not fall: {traj}")
    steps = done.get("steps_run", 0) + 1                    # and the warm-up
    launches = done.get("launches", {})
    layers = done.get("teacher_layers", 0) + DRAFT_LAYERS
    want = {"flash_attention_fwd": layers * steps,
            "flash_attention_bwd_dkdv": DRAFT_LAYERS * steps,
            "flash_attention_bwd_dq": DRAFT_LAYERS * steps}
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if problems:
        raise RuntimeError("distill phase: " + "; ".join(problems))
    tokens = DISTILL_BATCH * DISTILL_SEQ
    step_s = tokens / done["tokens_per_sec"]
    # the teacher's forward and the student's forward and backward, 2 and
    # 6 flops a weight a token, against the bf16 peak
    line = {"distill": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(DISTILL_ARGS) + " --out DIR",
        "teacher": "llama3_8b", "draft_layers": done["draft_layers"],
        "batch": DISTILL_BATCH, "seq": DISTILL_SEQ,
        "steps_run": done["steps_run"], "loss_first": done["loss_first"],
        "loss_final": done["loss_final"],
        "loss_trajectory": done["loss_trajectory"],
        "tokens_per_s": done["tokens_per_sec"], "step_s": step_s,
        "step_s_predicted": list(DISTILL_STEP_S_PREDICTED),
        "peak_mem_gb": done["peak_mem_gb"],
        "peak_mem_gb_predicted": DISTILL_PEAK_GB_PREDICTED,
        "checkpoint_save_s": saved["save_s"],
        "artifact_save_s": saved["draft_save_s"],
        "process_wall_s": wall, "launches": launches, "card": card}}
    log(f"[distill] {line}")
    return line, launches, saved["path"]


def phase_distill_serve(card, artifact, solo_replies, params, truncated):
    """The distilled artifact served as phase 7's worker serves the
    truncated one: ``spec_armed`` (a ``spec_fallback`` fails), phase 6's
    8 requests, every served token held to the target under the near-tie
    rule; its acceptance beside the truncated draft's ``truncated``."""
    from dcos_commons_tpu_torch.models import llama
    extra = ("--pages", "64", "--spec-decode", "true", "--draft-checkpoint",
             artifact, "--draft-k", str(SPEC_K))
    line, launches, replies, events = phase_worker(
        card, "worker_distilled", extra, "PagedServer",
        ("flash_decode", "flash_attention_fwd"), expect=("spec_armed",),
        forbid=("paged_fallback", "spec_fallback"))
    armed = next(e for e in events if e["event"] == "spec_armed")
    body = line["worker_distilled"]
    if armed["draft_step"] != DISTILL_STEPS:
        raise RuntimeError(f"worker_distilled armed {armed}")
    bodies = worker_bodies()
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    body["divergences"] = stream_check(
        "worker_distilled", dict(enumerate(replies)),
        dict(enumerate(solo_replies)),
        {i: b["prompt"] for i, b in enumerate(bodies)}, cfg, params)
    body["spec_armed"] = armed
    spec = body["paged"]["spec"]
    body["accept_rate_distilled"] = spec["accept_rate"]
    body["accept_rate_truncated"] = truncated
    log(f"[worker_distilled] accepted {spec['accepted']} of "
        f"{spec['proposed']} ({spec['accept_rate']}) against the truncated "
        f"draft's {truncated}")
    return line, launches


# --------------------------------------------------------------- phase 9

LT_FRESH, LT_RESUMED, LT_FLASH = 3, 5, 2
LT_LAYERS = 4                   # LlamaConfig.tiny


def _saved_counts(out: Path, step: int) -> tuple:
    """(Adam count, schedule count) of a train checkpoint's step."""
    import numpy as np
    d = out / f"step-{step:08d}-p0"
    return tuple(int(np.fromfile(d / f"opt_state.{k}.count.o.bin",
                                 dtype=np.int32)[0]) for k in ("1.0", "1.2"))


def phase_llama_train(card: str) -> dict:
    """``llama-train`` (the tiny config at its defaults: batch 2 x 256,
    head_dim 8, ``--attn auto``, which is dense as the reference's
    ``auto`` under its train mesh) as subprocesses: a fresh ``--steps 3``
    (counts 4 saved, the warm-up's update kept), ``--steps 5`` on the
    same volume (``resumed`` at 3, 2 steps), and a long ``--ckpt-every
    1`` run SIGTERM'd after its first ``checkpoint`` (``sigterm``,
    ``preempted`` with ``flushed_step``, exit 143) whose relaunch resumes
    at the flushed step; kernels 3-5 launch 0 times in these runs. Then
    ``--attn flash --steps 2``, which the reference runs through its
    kernel at this shape: kernels 3-5 launch once a layer for the
    warm-up and each step."""
    import math
    import shutil
    import signal

    base = Path(__file__).resolve().parent / "build" / "lt_smoke"
    shutil.rmtree(base, ignore_errors=True)
    vol, vol2 = base / "vol", base / "vol2"
    base.mkdir(parents=True)
    problems, runs = [], {}

    def run(name, args, want_launches=0, **kw):
        t0 = time.perf_counter()
        rc, events = _worker_run(["llama-train", *args], base, **kw)
        runs[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                      "events": [e["event"] for e in events]}
        done = [e for e in events if e.get("event") == "done"]
        if done:
            launches = runs[name]["launches"] = done[0].get("launches")
            if launches is None or set(launches.values()) != {want_launches}:
                problems.append(f"{name}: kernel launches {launches}, want "
                                f"{want_launches} each")
        return rc, events, done[0] if done else {}

    rc, _, done = run("fresh", ["--steps", str(LT_FRESH), "--out", str(vol)])
    if rc != 0 or done.get("steps_run") != LT_FRESH \
            or not math.isfinite(done.get("final_loss") or math.nan):
        problems.append(f"fresh: exit {rc}, {done}")
    elif _saved_counts(vol, LT_FRESH) != (LT_FRESH + 1,) * 2:
        problems.append(f"fresh: counts {_saved_counts(vol, LT_FRESH)}")
    rc, events, done = run("resumed", ["--steps", str(LT_RESUMED), "--out",
                                       str(vol)])
    resumed = [e["step"] for e in events if e.get("event") == "resumed"]
    if rc != 0 or resumed != [LT_FRESH] \
            or done.get("steps_run") != LT_RESUMED - LT_FRESH:
        problems.append(f"resumed: exit {rc}, resumed at {resumed}, {done}")

    sent = []

    def preempt(proc, event):
        # once: the flush emits a checkpoint event too
        if event.get("event") == "checkpoint" and not sent:
            sent.append(event["step"])
            proc.send_signal(signal.SIGTERM)

    rc, events, done = run("sigterm", ["--steps", "1000000", "--ckpt-every",
                                       "1", "--out", str(vol2)],
                           on_event=preempt)
    pre = [e for e in events if e.get("event") == "preempted"]
    flushed = pre[0]["flushed_step"] if pre else None
    if rc != 143 or "sigterm" not in runs["sigterm"]["events"] \
            or len(pre) != 1 or done.get("resume_step") != flushed:
        problems.append(f"sigterm: exit {rc}, events "
                        f"{runs['sigterm']['events'][-6:]}, {done}")
    else:
        rc, events, done = run("relaunch", ["--steps", str(flushed + 2),
                                            "--out", str(vol2)])
        resumed = [e["step"] for e in events if e.get("event") == "resumed"]
        if rc != 0 or resumed != [flushed] or done.get("steps_run") != 2:
            problems.append(f"relaunch: exit {rc}, resumed at {resumed}, "
                            f"{done}")
    rc, _, done = run("flash", ["--attn", "flash", "--steps", str(LT_FLASH)],
                      want_launches=(LT_FLASH + 1) * LT_LAYERS)
    if rc != 0 or done.get("steps_run") != LT_FLASH \
            or not math.isfinite(done.get("final_loss") or math.nan):
        problems.append(f"flash: exit {rc}, {done}")
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("llama-train phase: " + "; ".join(problems))
    line = {"llama_train": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   "llama-train", "model": "tiny", "batch": 2, "seq": 256,
        "head_dim": 8,
        "attn": "auto (dense, the reference's auto under its train mesh); "
                "flash (kernels 3-5, head_dim padded to 64)",
        "flushed_step": flushed, "runs": runs, "card": card}}
    log(f"[llama_train] {line}")
    return line


# --------------------------------------------------------------- phase 10

# Mixtral-8x7B's routing geometry at the 8b preset's widths: 8 experts,
# top-2, dropless (the capacity default of the moe.yml service)
MOE_EXPERTS = 8
# dist/moe.yml's worker flags at the 8b preset
WORKER_MOE_ARGS = ("--pages", "-1", "--moe-experts", str(MOE_EXPERTS),
                   "--moe-capacity-factor", "0")
# moe_apply_local on the card vs the port's CPU result, both fp32 (TF32
# off): outputs within this share of max |out| (the products' sums in
# another order), and the same dropped rows
MOE_APPLY_RTOL = 1e-5
MOE_APPLY_TOKENS = 64                  # one prefill chunk
# the reckoning before the first run: weights 64.9 GB (60.13 GB of expert
# banks), every expert read each step under dropless capacity (63.9 GB,
# 19.1 ms at 3.35 TB/s)
MOE_WEIGHT_GB_PREDICTED = 64.9
MOE_STEP_BOUND_MS = 63.9e9 / HBM_BYTES_PER_S * 1e3
# In bf16 two valid computations of the MoE model route differently: one
# 1,500-token prompt prefilled in 64-token chunks and whole differs in
# 2,642 of its 48,000 top-2 decisions (the router logits' median
# difference 0.012, from bf16 roundings carried through the layers), and
# a flipped expert changes its token's output by a whole expert's
# contribution, so a stream's logits move by up to 0.84 at such a token.
# A stream may therefore leave the stepwise reference at any token, and
# the token-level near-tie rule cannot hold. In bf16 the share of tokens
# within NEAR_TIE_ATOL of the teacher's top logit must reach this
# (measured 0.943-0.951 over phase 3's 12 streams; a wrong expert
# product or combine puts most tokens far from the top). Exact parity
# with the reference is held in fp32 at MOE_FP32_LAYERS layers of the
# full width, where nothing flips (12 of 12 streams token-exact).
MOE_NEAR_TIE_SHARE = 0.8
MOE_FP32_LAYERS = 4


def _moe_apply_check(params) -> dict:
    """``moe_apply_local`` on the card against the port's CPU result, in
    fp32, on layer 0's router and expert banks (cast to fp32) and
    ``MOE_APPLY_TOKENS`` random tokens: top-2 dropless, and at capacity
    factor 1.0, where tokens are dropped."""
    import torch
    from dcos_commons_tpu_torch.parallel.moe import (MoEConfig, dropless,
                                                     moe_apply_local)
    lp = params["layers"]
    dev = (lp["router"][0], lp["w_in"][0].float(), lp["w_out"][0].float())
    cpu = [t.cpu() for t in dev]
    x = torch.randn((MOE_APPLY_TOKENS, cpu[1].shape[1]),
                    generator=torch.Generator().manual_seed(SEED + 10))
    out = {}
    for name, cfg in (("top2_dropless", dropless(MoEConfig(MOE_EXPERTS))),
                      ("top2_factor_1", MoEConfig(MOE_EXPERTS,
                                                  capacity_factor=1.0))):
        want, _ = moe_apply_local(x, *cpu, cfg)
        got, _ = moe_apply_local(x.to(dev[0].device), *dev, cfg)
        got = got.cpu()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        dropped = (want == 0).all(-1)
        if err > MOE_APPLY_RTOL * scale or not torch.equal(
                (got == 0).all(-1), dropped):
            raise RuntimeError(f"moe_apply_local {name}: card vs CPU max "
                               f"|diff| {err} (tol {MOE_APPLY_RTOL} x "
                               f"{scale}), dropped rows differ or not")
        out[name] = {"max_abs_err": err, "max_abs_out": scale,
                     "dropped_tokens": int(dropped.sum()),
                     "tokens": MOE_APPLY_TOKENS}
    return out


def moe_split(srv) -> dict:
    """A graphed MoE decode step's device time by part, from the engine's
    live state (8 decoding streams): the whole step, and for every layer
    the routing (FFN norm, router product, softmax and the top-2 dispatch
    tensors), the two one-hot products (dispatch and combine), the expert
    products (two batched matmuls and the silu), the casts around them
    and kernel 1 alone. Each part is captured as its own CUDA graph on
    clones of the state and timed over replays (:func:`graph_ms`); the
    rest of the step is the attention projections, rope, the K/V writes,
    the residual adds and the lm_head."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.flash_decode import flash_decode_paged
    from dcos_commons_tpu_torch.ops.norms import rms_norm
    from dcos_commons_tpu_torch.parallel import moe as pm

    cfg, moe, dev = srv.cfg, srv.moe, srv.device
    lay = srv.params["layers"]
    nl, b = cfg.n_layers, srv.slots
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    mp = min(srv.pages_per_stream, int(ln.max()) // srv.page_size + 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=dev)
    pool = {s: t.clone() for s, t in srv.pool.items()}
    dispatch_fn = (pm.expert_choice_dispatch
                   if moe.routing == "expert_choice" else pm.top2_dispatch)
    cap = moe.capacity(b)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(cfg.dtype)
    gates = torch.softmax(x.float() @ lay["router"][0], dim=-1)
    combine, dispatch = dispatch_fn(gates, cap)
    comb, disp = combine.to(cfg.dtype), dispatch.to(cfg.dtype)
    expert_in = torch.einsum("gec,gd->ecd", disp, x)
    q = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(cfg.dtype)
    kv_len = (ln + 1).to(torch.int32)

    def step():
        llama.decode_step_paged(cfg, srv.params, pool, tbl, ln, tok,
                                rope=srv._rope, ffn_override=srv._ffn)

    def route():
        for i in range(nl):
            h = rms_norm(x, lay["ffn_norm"][i], cfg.norm_eps)
            dispatch_fn(torch.softmax(h.float() @ lay["router"][i], dim=-1),
                        cap)

    def dispatch_combine():
        for _ in range(nl):
            torch.einsum("gec,gd->ecd", disp, x)
            torch.einsum("gec,ecd->gd", comb, expert_in)

    def experts():
        for i in range(nl):
            h = torch.bmm(expert_in, lay["w_in"][i])
            torch.bmm(h * torch.sigmoid(h), lay["w_out"][i])

    def casts():
        for _ in range(nl):
            x.float()
            combine.to(cfg.dtype)
            dispatch.to(cfg.dtype)
            (x + x.float().to(cfg.dtype))

    def kernel_1():
        for i in range(nl):
            flash_decode_paged(q, pool["k"][i], pool["v"][i], tbl, kv_len)

    parts = {"route_ms": graph_ms(route),
             "dispatch_combine_ms": graph_ms(dispatch_combine),
             "expert_products_ms": graph_ms(experts),
             "casts_ms": graph_ms(casts),
             "kernel_1_ms": graph_ms(kernel_1)}
    step_ms = graph_ms(step)
    del pool
    expert_bytes = sum(lay[k].numel() * lay[k].element_size()
                       for k in ("w_in", "w_out"))
    return {"batch": b, "capacity": cap, "table_width": mp,
            "positions_max": int(ln.max()) + 1, "step_ms": step_ms, **parts,
            "rest_ms": step_ms - sum(parts.values()),
            "expert_share": parts["expert_products_ms"] / step_ms,
            "expert_bytes_gb": expert_bytes / 1e9,
            "expert_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
            "expert_gb_per_s": expert_bytes / parts["expert_products_ms"]
            / 1e6}


def phase_moe(card: str) -> tuple:
    """MoE serving in process at Llama-3-8B widths and depth with 8
    experts (top-2, dropless): ``init_moe_params`` from the seed,
    ``PagedServer(moe=...)`` warmed up, then with the kernel counts zeroed
    phase 3's 12 requests drained as phase 3 drains them, the workers' 8
    requests drained at window 8 (the tokens the MoE worker is held to),
    and each of the 12 streams decoded alone by ``generate_stepwise_moe``
    (kernel 2); the counts are read after. The engine's streams are held
    to the MoE target by :func:`moe_stream_share`, ``moe_apply_local`` on
    the card to the CPU, graphed windows bitwise to the eager loop at
    B=8, and, once the bf16 model is freed, the engine to
    ``generate_stepwise_moe`` token for token in fp32 at reduced depth
    (:func:`_moe_fp32_parity`). Returns (line, launches, the workers'
    streams from the engine)."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    dev = torch.device("cuda")
    resident_gb = torch.cuda.memory_allocated() / 1e9
    if resident_gb > 4:
        raise RuntimeError(f"moe phase: {resident_gb:.1f} GB still resident "
                           "before the 65 GB MoE weights")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    moe = dropless(MoEConfig(MOE_EXPERTS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_moe_params(
        cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size()
                    for t in [params["embed"], params["norm"],
                              params["lm_head"], *params["layers"].values()]
                    ) / 1e9
    log(f"[moe] init {weight_gb:.2f} GB of MoE params in {init_s:.1f} s")
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, moe=moe, device=dev)
    warm = srv.warmup()
    queue = serve_queue(cfg.vocab_size)
    workers = [{"prompt": b["prompt"], "max_new": b["max_new"],
                "request_id": f"w{i}"} for i, b in enumerate(worker_bodies())]
    prompts = {r["request_id"]: r["prompt"] for r in queue + workers}
    fd.flash_decode_paged.launches = 0
    fd.flash_decode.launches = 0
    wall, ttft = drain_timed(srv, queue)
    out = {rid: srv.finished[rid] for rid in prompts if rid in srv.finished}
    worker_want = srv.drain([dict(r) for r in workers], decode_window=8)
    worker_want = {rid: worker_want[rid] for rid in prompts
                   if rid.startswith("w")}
    t_ref = time.perf_counter()
    want = {r["request_id"]: llama.generate_stepwise_moe(
        cfg, params, torch.tensor([r["prompt"]], dtype=torch.int32,
                                  device=dev), r["max_new"], moe)[0].tolist()
        for r in queue}
    ref_s = time.perf_counter() - t_ref
    launches = {"flash_decode_paged": fd.flash_decode_paged.launches,
                "flash_decode": fd.flash_decode.launches}
    problems = []
    if sorted(out) != sorted(want) or sorted(worker_want) != sorted(
            r["request_id"] for r in workers):
        problems.append(f"finished {sorted(out)} {sorted(worker_want)}")
    for rid, toks in {**out, **worker_want}.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            problems.append(f"{rid}: {len(toks)} tokens or one outside the "
                            "vocabulary")
    if srv.ledger_violations():
        problems.append(f"ledger: {srv.ledger_violations()[:3]}")
    stats = srv.page_stats()
    if stats["prefix_hits"] < 1:
        problems.append("no prefix hit")
    for name, n in launches.items():
        if n < 1:
            problems.append(f"{name} never launched on the MoE path")
    if problems:
        raise RuntimeError("moe phase: " + "; ".join(problems))
    differ = sum(a != b for rid in want for a, b in zip(out[rid], want[rid]))
    near_tie = moe_stream_share("moe engine vs generate_stepwise_moe", out,
                                want, prompts, cfg, params, srv._ffn)
    apply_check = _moe_apply_check(params)
    t_chunk = []
    row = torch.full((srv.pages_per_stream,), srv.scratch, dtype=torch.int32,
                     device=dev)
    chunk = torch.zeros((1, srv.prefill_chunk), dtype=torch.int32, device=dev)
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        llama.prefill_chunk_paged(cfg, params, srv.pool, row, chunk, 0,
                                  srv.prefill_chunk, srv.prefill_chunk - 1,
                                  srv.scratch, rope=srv._rope,
                                  ffn_override=srv._ffn)
        torch.cuda.synchronize()
        t_chunk.append((time.perf_counter() - t1) * 1e3)
    steady_streams(srv)
    steady = _graph_vs_eager(srv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(t) for t in out.values())
    ttfts = sorted(ttft.values())
    line = {"moe": {
        "model": "llama3_8b widths and depth, 8 experts top-2 "
                 "(Mixtral-8x7B routing geometry)",
        "max_seq": cfg.max_seq, "layers": cfg.n_layers, "dtype": "bf16",
        "experts": MOE_EXPERTS, "routing": moe.routing,
        "capacity_factor": moe.capacity_factor, "slots": 8, "page_size": 64,
        "prefill_chunk": 64, "weight_gb": weight_gb,
        "weight_gb_predicted": MOE_WEIGHT_GB_PREDICTED, "init_s": init_s,
        "warmup_s": warm, "requests": len(out), "tokens_out": n_tok,
        "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "decode_step_ms_b8": steady["graph_step_ms"],
        "eager_step_ms_b8": steady["eager_step_ms"],
        "decode_tok_s_b8": 8 / steady["graph_step_ms"] * 1e3,
        "step_bound_ms": MOE_STEP_BOUND_MS,
        "prefill_chunk_ms": sorted(t_chunk)[len(t_chunk) // 2],
        "prefill_chunk_ms_all": t_chunk, "steady_b8_window8": steady,
        "stepwise_reference_s": ref_s, "tokens_differing_from_stepwise":
            differ, "bf16_vs_stepwise": near_tie,
        "moe_apply_card_vs_cpu": apply_check, "launches": launches,
        "peak_mem_gb": peak_gb, "page_stats_moe": stats["moe"],
        "page_stats": stats, "graphs": _graph_line(srv), "card": card}}
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    line["moe"]["fp32_parity"] = _moe_fp32_parity(queue)
    log(f"[moe] {line}")
    return line, launches, worker_want


def moe_stream_share(name, got, want, prompts, cfg, params, ffn) -> dict:
    """Each bf16 stream of ``got`` teacher-forced through the MoE target
    (:func:`_teacher_gaps`): the share of tokens within ``NEAR_TIE_ATOL``
    of the top logit at their position must reach ``MOE_NEAR_TIE_SHARE``
    (see there). Returns where each stream first leaves ``want``, the
    share and the largest gap; raises below the share."""
    from dcos_commons_tpu_torch.ops.rotary import rope_frequencies
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=params["norm"].device)
    gaps, divergences = [], []
    for rid, w in want.items():
        g = got[rid]
        row = _teacher_gaps(cfg, params, rope, prompts[rid], g, ffn)
        gaps += row
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            divergences.append({"stream": rid, "at": j, "gap": row[j]})
    share = sum(gap <= NEAR_TIE_ATOL for gap in gaps) / len(gaps)
    out = {"tokens": len(gaps), "near_tie_share": share,
           "near_tie_share_floor": MOE_NEAR_TIE_SHARE,
           "tokens_away_from_a_near_tie": sum(gap > NEAR_TIE_ATOL
                                              for gap in gaps),
           "max_gap": max(gaps), "streams_equal": len(want) - len(
               divergences), "divergences": divergences}
    log(f"[check] {name}: {out}")
    if share < MOE_NEAR_TIE_SHARE:
        raise RuntimeError(f"{name}: only {share:.3f} of {len(gaps)} tokens "
                           f"within {NEAR_TIE_ATOL} of the target's top "
                           f"logit (floor {MOE_NEAR_TIE_SHARE})")
    return out


def _moe_fp32_parity(queue) -> dict:
    """The MoE engine against ``generate_stepwise_moe`` on the card in
    fp32 (TF32 off) at the full width with ``MOE_FP32_LAYERS`` layers and
    8 experts (dense attention: the decode kernels take bf16): phase 3's
    12 requests drained as phase 3 drains them, every stream token-exact,
    as on the CPU. Frees what it builds."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048, n_layers=MOE_FP32_LAYERS,
                                      dtype=torch.float32,
                                      decode_attn="dense")
    moe = dropless(MoEConfig(MOE_EXPERTS))
    params = llama.init_moe_params(
        cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, moe=moe, device=dev)
    t0 = time.perf_counter()
    drain_timed(srv, queue)
    differ = {}
    for r in queue:
        want = llama.generate_stepwise_moe(
            cfg, params, torch.tensor([r["prompt"]], dtype=torch.int32,
                                      device=dev), r["max_new"], moe)
        got = srv.finished[r["request_id"]]
        if got != want[0].tolist():
            differ[r["request_id"]] = next(
                i for i, (a, b) in enumerate(zip(got, want[0].tolist()))
                if a != b)
    seconds = time.perf_counter() - t0
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    if differ:
        raise RuntimeError(f"moe fp32 parity: streams leave "
                           f"generate_stepwise_moe at {differ}")
    return {"layers": MOE_FP32_LAYERS, "dtype": "fp32", "streams_equal":
            len(queue), "of": len(queue), "seconds": seconds}


def phase_moe_worker(card, want) -> tuple:
    """The worker with dist/moe.yml's flags at the 8b preset
    (``WORKER_MOE_ARGS``): ``moe_fallback`` or ``paged_fallback`` fails
    the phase; the 8 worker requests, each reply held to the in-process
    engine's stream for the same prompt ``want`` (the same weights, drawn
    from seed 0 by the same function): equal, or, where streams leave
    it, held by :func:`moe_stream_share` (weights drawn again once the
    worker has exited).
    Kernel 1's launches are the worker's while it served, kernel 2's its
    timed decode's (``generate_stepwise_moe`` before serving). Returns
    (line, launches)."""
    import torch
    line, launches, replies, events = phase_worker(
        card, "worker_moe", WORKER_MOE_ARGS, "PagedServer",
        ("flash_decode_paged",),
        forbid=("paged_fallback", "moe_fallback"))
    body = line["worker_moe"]
    serving = next(e for e in events if e.get("event") == "serving")
    launches["flash_decode"] = serving.get("launches", {}).get(
        "flash_decode", 0)
    problems = []
    if launches["flash_decode"] < 1:
        problems.append("the worker's timed decode never launched "
                        "flash_decode")
    moe_stats = (body.get("paged") or {}).get("moe")
    if moe_stats != {"experts": MOE_EXPERTS,
                     "capacity_factor": float(MOE_EXPERTS),
                     "routing": "top2"}:
        problems.append(f"page_stats moe {moe_stats}")
    if problems:
        raise RuntimeError("worker_moe phase: " + "; ".join(problems))
    got = {f"w{i}": toks for i, toks in enumerate(replies)}
    differ = [rid for rid in want if got[rid] != want[rid]]
    body["streams_equal_in_process"] = len(want) - len(differ)
    body["bf16_vs_in_process"] = None
    if differ:
        from dcos_commons_tpu_torch.models import llama
        from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless
        dev = torch.device("cuda")
        cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
        params = llama.init_moe_params(
            cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
            device=dev)
        prompts = {f"w{i}": b["prompt"]
                   for i, b in enumerate(worker_bodies())}
        body["bf16_vs_in_process"] = moe_stream_share(
            "MoE worker vs the in-process engine",
            {rid: got[rid] for rid in differ},
            {rid: want[rid] for rid in differ}, prompts, cfg, params,
            llama.make_moe_ffn(cfg, dropless(MoEConfig(MOE_EXPERTS))))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    body["model"] = ("llama3_8b widths and depth, 8 experts top-2 "
                     "(Mixtral-8x7B routing geometry)")
    body["launches"] = launches
    log(f"[worker_moe] streams equal {body['streams_equal_in_process']}, "
        f"bf16 hold {body['bf16_vs_in_process']}")
    return line, launches


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
            "library_ms": head["library_ms"],
            "bound_share": head.get("bound_share"), "tolerance": tolerance,
            "cases": cases}


PHASE_S = {}


def timed_phase(name, fn, *args, **kw):
    """Run one phase and keep its wall seconds in ``PHASE_S``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        log(f"[phase] {name} {PHASE_S[name]:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 1
    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed_phase("1_build", phase_build)
    card = card_line()
    log(f"[card] {card}")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    decode_cases, slot_cases, fa_cases = timed_phase(
        "2_kernels", phase_kernels, flush)
    del flush
    torch.cuda.empty_cache()
    distill_line, distill_launches, distilled = timed_phase(
        "8_distill", phase_distill, card)
    serving_line, decode_launches, params, solo = timed_phase(
        "3_serve", phase_serve, card)
    torch.cuda.empty_cache()
    spec_line, spec_launches = timed_phase("7_spec", phase_spec, card,
                                           params, solo)
    artifact = save_spec_draft(params)
    gc.collect()
    torch.cuda.empty_cache()
    slots_line, slot_launches = timed_phase("5_serve_slots",
                                            phase_serve_slots, card, params)
    # the front door's handler closes over the front door, a cycle that
    # holds the engine until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    worker_lines, worker_launches, replies = [], {}, {}
    for name, extra, engine, names in WORKER_ENGINES:
        line, launches, replies[name], _ = timed_phase(
            f"6_{name}", phase_worker, card, name, extra, engine, names)
        worker_lines.append(line)
        worker_launches.update(launches)
    try:
        t0 = time.perf_counter()
        spec_worker_line, spec_worker_launches = timed_phase(
            "7_worker_spec", phase_spec_worker, card, artifact,
            replies["worker_paged"], params)
        spec_worker_s = time.perf_counter() - t0
        distilled_line, distilled_launches = timed_phase(
            "8_worker_distilled", phase_distill_serve, card, distilled,
            replies["worker_paged"], params, spec_line["accept_rate"])
    finally:
        import shutil
        shutil.rmtree(artifact["path"], ignore_errors=True)
        shutil.rmtree(Path(distilled).parent, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe_line, moe_launches, moe_worker_want = timed_phase(
        "10_moe", phase_moe, card)
    moe_worker_line, moe_worker_launches = timed_phase(
        "10_worker_moe", phase_moe_worker, card, moe_worker_want)
    training_line, fa_launches = timed_phase("4_train", phase_train, card)
    llama_train_line = timed_phase("9_llama_train", phase_llama_train, card)
    ws = spec_worker_line["worker_spec"]
    spec_summary = {
        "windows": spec_line["windows"], "proposed": spec_line["proposed"],
        "accepted": spec_line["accepted"],
        "accept_rate_truncated": spec_line["accept_rate"],
        "accept_rate_self": spec_line["self_draft"]["accept_rate"],
        "fallbacks": spec_line["fallbacks"],
        "window_ms_graphed": spec_line["graphed_vs_eager"]["graph_window_ms"],
        "window_ms_eager": spec_line["graphed_vs_eager"]["eager_window_ms"],
        "tokens_per_target_pass":
            spec_line["graphed_vs_eager"]["tokens_per_target_pass"],
        "verify_share": spec_line["graphed_vs_eager"]["split"][
            "verify_share"],
        "draft_prefill_s": spec_line["draft_prefill_s"],
        "artifact_save_s": artifact["save_s"],
        "artifact_load_s": ws["spec_armed"]["load_s"],
        "artifact_bytes": artifact["bytes"],
        "worker_boot_s": ws["boot_to_serving_s"],
        "worker_phase_s": spec_worker_s,
        "worker_ttft_p50_ms": ws["ttft_p50_ms"],
        "worker_tpot_p50_ms": ws["tpot_p50_ms"],
        "worker_output_tok_s": ws["output_tok_s"],
        "near_tie_divergences": (len(spec_line["divergences"])
                                 + len(spec_line["self_draft"]["divergences"])
                                 + len(ws["divergences"])),
        "accept_rate_distilled":
            distilled_line["worker_distilled"]["accept_rate_distilled"],
        "engine": spec_line, "card": card}
    fa_tol = {"rtol": FA_RTOL,
              "atol": f"{FA_SCALED_ATOL} * max|plain| of each row of a head "
                      "(O) or of the tensor (gradients)",
              "lse_atol": LSE_ATOL}
    csrc = "dcos_commons_tpu_torch/csrc/"
    decode_tol = {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL}
    kernels = [
        _kernel_entry("flash_decode_paged", csrc + "flash_decode_paged.cu",
                      "dcos_commons_tpu/ops/flash_decode.py:263",
                      {"serving": decode_launches,
                       "worker_paged": worker_launches["flash_decode_paged"],
                       "spec": spec_launches["flash_decode_paged"],
                       "moe": moe_launches["flash_decode_paged"],
                       "worker_moe":
                           moe_worker_launches["flash_decode_paged"]},
                      decode_cases,
                      decode_tol),
        _kernel_entry("flash_decode", csrc + "flash_decode_slots.cu",
                      "dcos_commons_tpu/ops/flash_decode.py:55",
                      {"serving_slots": slot_launches["flash_decode"],
                       "worker": worker_launches["flash_decode"],
                       "spec": spec_launches["flash_decode"],
                       "worker_spec": spec_worker_launches["flash_decode"],
                       "worker_distilled":
                           distilled_launches["flash_decode"],
                       "moe": moe_launches["flash_decode"],
                       "worker_moe": moe_worker_launches["flash_decode"]},
                      slot_cases, decode_tol),
        _kernel_entry("flash_attention_fwd", csrc + "flash_attention_fwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:62",
                      {"serving_slots": slot_launches["flash_attention_fwd"],
                       "worker": worker_launches["flash_attention_fwd"],
                       "spec": spec_launches["flash_attention_fwd"],
                       "worker_spec":
                           spec_worker_launches["flash_attention_fwd"],
                       "worker_distilled":
                           distilled_launches["flash_attention_fwd"],
                       "training": fa_launches["flash_attention_fwd"],
                       "distill": distill_launches["flash_attention_fwd"]},
                      fa_cases["fwd"], fa_tol),
        _kernel_entry("flash_attention_bwd_dkdv",
                      csrc + "flash_attention_bwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:214",
                      {"training": fa_launches["flash_attention_bwd_dkdv"],
                       "distill":
                           distill_launches["flash_attention_bwd_dkdv"]},
                      fa_cases["dkdv"], fa_tol),
        _kernel_entry("flash_attention_bwd_dq",
                      csrc + "flash_attention_bwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:256",
                      {"training": fa_launches["flash_attention_bwd_dq"],
                       "distill": distill_launches["flash_attention_bwd_dq"]},
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
    for line in worker_lines:
        print(json.dumps(line), flush=True)
    print(json.dumps(spec_worker_line), flush=True)
    print(json.dumps(distilled_line), flush=True)
    print(json.dumps(training_line), flush=True)
    print(json.dumps(distill_line), flush=True)
    print(json.dumps(llama_train_line), flush=True)
    print(json.dumps({"spec": spec_summary}), flush=True)
    print(json.dumps(moe_line), flush=True)
    print(json.dumps(moe_worker_line), flush=True)
    PHASE_S["total"] = time.perf_counter() - t_main
    PHASE_S["unaccounted"] = PHASE_S["total"] - sum(
        v for k, v in PHASE_S.items() if k != "total")
    print(json.dumps({"phase_s": PHASE_S}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
