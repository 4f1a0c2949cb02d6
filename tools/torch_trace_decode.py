#!/usr/bin/env python3
"""Where the time goes inside one launch of the decode kernels, block by
block, on one NVIDIA GPU (the card's machine has no ncu or nsys).

    python3 tools/torch_trace_decode.py

Copies ``dcos_commons_tpu_torch/csrc``'s decode sources into
``build/torch_trace_decode/`` with marks added: thread 0 of each block
writes the global timer (``%globaltimer``, ns) into a device array at the
kernel's entry, after its set-up barrier, when producer warp 0 has issued
each stage, when the consumers have each stage, at each item's end and
after its merge, after the block's counts and at its end. Builds the copy,
runs each kernel once on ``chip_smoke.py``'s main case (bf16, ``KV_LENS``;
page size 64 for the paged kernel) after an L2 flush, and prints one JSON
line per kernel: the spread of the blocks' ends, the mean of each mark
over the blocks, and the timelines of the blocks that end last and first,
in microseconds from the first block's entry. The marks themselves cost
a few stores a block. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

OUT = ROOT / "build" / "torch_trace_decode"
FILES = ("flash_decode_common.cuh", "flash_decode_paged.cu",
         "flash_decode_slots.cu")
SLOTS = 64                 # marks per block
# mark slots: 0 entry, 1 after set-up, 2.. stage issued (10), 12.. stage
# full (12), 24 + 4 i item i's stages done, 25 + 4 i merged (6 items),
# 26 + 4 i its stream and chunks, 58 counts done, 59 last merges begin,
# 60 items done, 61 partials announced, 63 end
MARKS = [
    ("namespace flash_decode {\n",
     "namespace flash_decode {\n"
     "__device__ long long g_trace[1024][64];\n"
     "__device__ __forceinline__ void mark(int slot) {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  if (slot < 64 && blockIdx.x < 1024) g_trace[blockIdx.x][slot] = t;\n"
     "}\n"),
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  for (int b = threadIdx.x;",
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  if (threadIdx.x == 0) mark(0);\n"
     "  for (int b = threadIdx.x;"),
    ("  __syncthreads();\n  if (warp >= kConsumerWarps) {\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) mark(1);\n"
     "  if (warp >= kConsumerWarps) {\n"),
    ("    cp_async_arrive(bar);\n    cur = nxt;",
     "    cp_async_arrive(bar);\n"
     "    if (lane == 0 && pw == 0 && stage < 10) mark(2 + stage);\n"
     "    cur = nxt;"),
    ("      mbar_wait(smem_addr(&full[slot]), (stage / C::kStages) & 1);\n"
     "      const int rows",
     "      mbar_wait(smem_addr(&full[slot]), (stage / C::kStages) & 1);\n"
     "      if (tid == 0 && stage < 12) mark(12 + stage);\n"
     "      const int rows"),
    ("    // merge the four warps into the item's partial\n",
     "    if (tid == 0 && item_no < 6) mark(24 + 4 * item_no);\n"
     "    // merge the four warps into the item's partial\n"),
    ("    consumer_sync();  // merge area free again\n  }",
     "    consumer_sync();  // merge area free again\n"
     "    if (tid == 0 && item_no < 6) {\n"
     "      mark(25 + 4 * item_no);\n"
     "      g_trace[blockIdx.x][26 + 4 * item_no] = it.n * 1000 + it.b;\n"
     "    }\n"
     "    ++item_no;\n  }\n  if (tid == 0) mark(60);"),
    ("  int stage = 0, n_ann = 0;\n",
     "  int stage = 0, n_ann = 0, item_no = 0;\n"),
    ("  announce(p, ann, n_ann, tid);\n  if (tid == 0) ann[3 * kMaxAnnounce]",
     "  announce(p, ann, n_ann, tid);\n"
     "  if (tid == 0) { mark(58); g_trace[blockIdx.x][61] = n_ann; }\n"
     "  if (tid == 0) ann[3 * kMaxAnnounce]"),
    ("  block_sync_late();\n  merge_last<D>(p, ann, n_ann, tid, kThreads);\n}",
     "  block_sync_late();\n  if (tid == 0) mark(59);\n"
     "  merge_last<D>(p, ann, n_ann, tid, kThreads);\n"
     "  if (tid == 0) mark(63);\n}"),
]


def make_copy() -> Path:
    """The traced copy of the committed sources; raises if a mark's place
    is no longer in the source (the kernel changed: update MARKS)."""
    from dcos_commons_tpu_torch.kernels import build
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for f in FILES:
        shutil.copy(build.CSRC / f, OUT / f)
    head = OUT / "flash_decode_common.cuh"
    text = head.read_text()
    for old, new in MARKS:
        if text.count(old) != 1:
            raise RuntimeError(f"mark place not found once: {old[:60]!r}")
        text = text.replace(old, new)
    head.write_text(text)
    for kind in ("paged", "slots"):
        src = OUT / f"flash_decode_{kind}.cu"
        src.write_text(src.read_text() + (
            f'\nextern "C" int flash_decode_{kind}_trace(long long* host) {{\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
            "      host, flash_decode::g_trace, sizeof(flash_decode::g_trace)));\n"
            "}\n"))
    return OUT


def timeline(row, t0) -> dict:
    def us(x):
        return None if x <= 0 else round((int(x) - t0) / 1e3, 3)

    items = []
    for i in range(6):
        done, merged, what = row[24 + 4 * i: 27 + 4 * i]
        if done <= 0:
            break
        items.append({"stream": int(what) % 1000,
                      "chunks": int(what) // 1000, "stages_done": us(done),
                      "merged": us(merged)})
    return {"entry": us(row[0]), "set_up": us(row[1]),
            "issued": [us(x) for x in row[2:12] if x > 0],
            "full": [us(x) for x in row[12:24] if x > 0], "items": items,
            "items_done": us(row[60]), "counts_done": us(row[58]),
            "last_merges_begin": us(row[59]),
            "announced": int(row[61]), "end": us(row[63])}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_decode: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import torch_bench_flash as tb
    from dcos_commons_tpu_torch.kernels import build

    where = make_copy()
    srcs = tb._decode_sources(str(where))
    build.build_all(list(srcs.values()))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for kind in ("paged", "slots"):
        run = tb._decode_launcher(srcs[kind], kind)
        lib = build.load(srcs[kind], {})
        args = (cs.decode_inputs("paged", False, cs.KV_LENS, cs.SEED + 64, 64)
                if kind == "paged" else
                cs.decode_inputs("slots", False, cs.KV_LENS, cs.SEED + 7))
        for _ in range(3):
            run(*args)
        torch.cuda.synchronize()
        flush.zero_()
        torch.cuda.synchronize()
        run(*args)
        torch.cuda.synchronize()
        buf = np.zeros((1024, SLOTS), dtype=np.int64)
        getattr(lib, f"flash_decode_{kind}_trace")(
            buf.ctypes.data_as(ctypes.c_void_p))
        used = buf[buf[:, 0] > 0]
        t0 = int(used[:, 0].min())
        lines = [timeline(r, t0) for r in used]
        order = sorted(range(len(lines)), key=lambda i: lines[i]["end"])

        def mean(key):
            vals = [x[key] for x in lines if x[key] is not None]
            return round(sum(vals) / len(vals), 3) if vals else None

        print(json.dumps({
            "kernel": kind, "blocks": len(lines),
            "end_first_us": lines[order[0]]["end"],
            "end_last_us": lines[order[-1]]["end"],
            "mean_us": {k: mean(k) for k in (
                "set_up", "items_done", "counts_done", "last_merges_begin",
                "end")},
            "last_full_mean_us": round(sum(x["full"][-1] for x in lines
                                           if x["full"]) / len(lines), 3),
            "latest_blocks": [lines[i] for i in order[-3:]],
            "earliest_block": lines[order[0]]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
