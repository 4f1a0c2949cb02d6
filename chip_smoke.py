#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dcos_commons_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every kernel of ``dcos_commons_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print the card;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of the main path (paged flash-decode: Llama-3-8B heads, B=8
   ragged streams, page sizes 64 and 128, bf16 and int8 pages) and time
   the kernel, the plain version, one library call as a yardstick, and
   the card's bound for the same work;
3. serve Llama-3-8B (full width and depth, random bf16 weights from a
   seed) through ``PagedServer``: about a dozen requests, two sharing a
   long prefix, decode windows 1 and 8; launch counts are zeroed just
   before and read just after; then one decode step through the kernel
   is held against the same step through the dense gather.

Output: the ``serving`` line, the ``kernels`` line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, it exits non-zero and
prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16
# tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
SEED = 0

# kernel vs plain version: both accumulate in fp32 and round once to
# bf16, so they differ by at most about one bf16 ulp (2^-7 relative)
KERNEL_RTOL, KERNEL_ATOL = 1e-2, 1e-3
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
    L2 flush (the decode step reads a different layer's pages each call,
    so the main path finds them cold)."""
    import torch
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# --------------------------------------------------------------- phase 1


def phase_build() -> None:
    from dcos_commons_tpu_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
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
    ms = timed_ms(lambda: fd._launch(q, k, v, table, kv_len, d ** -0.5),
                  iters, flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_paged_reference(
        q, k, v, table, kv_len), 10, flush)
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(n, span) for n in KV_LENS)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * mp * 4 + b * 4
    n_bytes = kv_bytes + io_bytes
    n_ops = 4 * live * h * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return {"page_size": ps, "pages": "int8" if int8 else "bf16",
            "max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def phase_kernels(flush) -> list:
    cases = [flash_decode_case(ps, int8, flush)
             for ps in (64, 128) for int8 in (False, True)]
    for c in cases:
        log(f"[kernel] flash_decode_paged {json.dumps(c)}")
    return cases


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
    lf, ld = logits["flash"], logits["dense"]
    diff = float((lf - ld).abs().max())
    top2 = torch.topk(ld, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
    agree = (lf.argmax(-1) == ld.argmax(-1)) | ~decided
    if diff > LOGIT_ATOL or not bool(agree.all()) \
            or not bool(torch.isfinite(lf).all()):
        raise RuntimeError(f"decode step kernel vs dense: max |dlogit| "
                           f"{diff:.4f} (tol {LOGIT_ATOL}), argmax agree "
                           f"{agree.tolist()}")
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
        "card": card}}, launches


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
    cases = phase_kernels(flush)
    del flush
    serving_line, launches = phase_serve(card)
    head = cases[0]                      # the main path: ps 64, bf16
    kernels = [{
        "name": "flash_decode_paged", "route": "cuda",
        "source": "dcos_commons_tpu_torch/csrc/flash_decode_paged.cu",
        "replaces": "dcos_commons_tpu/ops/flash_decode.py:263",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "tolerance": {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
        "cases": cases}]
    print(json.dumps(serving_line), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
