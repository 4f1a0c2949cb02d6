#!/usr/bin/env python3
"""Where a distill step of the PyTorch port spends its time on the GPU,
read from the worker's own ``--profile-dir`` trace.

    python3 tools/torch_profile_distill.py [--preset 8b] [--steps 3]
        [--batch 32] [--seq 256] [--trace FILE]

Runs ``python -m dcos_commons_tpu_torch.frameworks.worker distill
--preset 8b --draft-layers 1 --batch 32 --seq 256 --steps 3
--profile-dir build/distill_profile`` (the workload at the reference's
batch and sequence, without ``--out``, so no checkpoint is written), or
reads ``--trace`` from such a run, and splits each ``distill.step``
profiler range (one optimizer step and the loss read that ends it) by
the ranges the port marks: ``distill.teacher_forward``,
``distill.student_forward``, ``distill.kl_head`` (the fused head's
forward), ``fused_kl.backward``, the rest of ``train_step.backward`` (the
student's backward) and ``train_step.optimizer``. Each kernel or copy is
charged to the innermost range around the host call that launched it
(the trace's correlation ids). Prints one JSON line: per step, the host
wall time, each part's device ms, the device busy ms (the sum of kernel
and copy time) and the idle share (1 - busy / wall), the device ms by
kernel family (cuBLAS products, the flash-attention kernels, copies,
everything else), the top kernels,
the host's CUDA runtime and driver calls by time, and the card. Needs a CUDA device for a run; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# marked range -> part; the fused head's backward runs inside the step's
# backward, so the rest of train_step.backward is the student's
PARTS = {"distill.teacher_forward": "teacher_forward",
         "distill.student_forward": "student_forward",
         "distill.kl_head": "kl_head_forward",
         "fused_kl.backward": "kl_head_backward",
         "train_step.backward": "student_backward",
         "train_step.optimizer": "optimizer"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel-name fragments of each family; the first match wins
FAMILIES = (("flash_attention", ("flash_fwd", "flash_bwd")),
            ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
            ("copy", ("copy",)), ("other", ("",)))
# host API calls that launch device work: cuBLAS launches through the
# driver (cuLaunchKernelEx), most of torch through the runtime
HOST_CATS = ("cuda_runtime", "cuda_driver")


def run_worker(args) -> str:
    """The worker's distill run under ``--profile-dir``: the trace path."""
    prof = ROOT / "build" / "distill_profile"
    for old in prof.glob("*.json"):
        old.unlink()
    cmd = [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
           "distill", "--preset", args.preset, "--draft-layers", "1",
           "--batch", str(args.batch), "--seq", str(args.seq), "--steps",
           str(args.steps), "--profile-dir", str(prof)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"distill exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    traces = glob.glob(str(prof / "*.json"))
    if len(traces) != 1:
        raise RuntimeError(f"expected one trace under {prof}: {traces}")
    return traces[0]


def split(trace: dict) -> dict:
    """Per-step device ms by part, busy ms, wall ms and idle share."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") == "user_annotation"
                     and (e["name"] in PARTS or e["name"] == "distill.step")),
                    key=lambda r: r[0])
    steps = [r for r in ranges if r[2] == "distill.step"]
    if not steps:
        raise RuntimeError("the trace holds no distill.step range")
    launch_ts = {}
    for e in events:
        if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    starts = [r[0] for r in ranges]
    by_part = defaultdict(float)
    by_kernel = defaultdict(float)
    by_family = defaultdict(float)
    busy = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None or not any(s0 <= ts <= s1 for s0, s1, _ in steps):
            continue
        busy += e["dur"]
        by_kernel[e["name"][:80]] += e["dur"]
        low = e["name"].lower()
        by_family[next(fam for fam, keys in FAMILIES
                       if any(k in low for k in keys))] += e["dur"]
        # innermost marked range around the launch
        inner, inner_len = "other", float("inf")   # unmarked
        for s0, s1, name in ranges[:bisect.bisect_right(starts, ts)]:
            if name != "distill.step" and s0 <= ts <= s1 \
                    and s1 - s0 < inner_len:
                inner, inner_len = PARTS[name], s1 - s0
        by_part[inner] += e["dur"]
    n = len(steps)
    # the host's API calls inside the steps: where a busy host or a
    # synchronising call (allocation, copy to the host) idles the device
    runtime = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") in HOST_CATS \
                and any(s0 <= e["ts"] <= s1 for s0, s1, _ in steps):
            runtime[e["name"]][0] += 1
            runtime[e["name"]][1] += e["dur"]
    wall = sum(s1 - s0 for s0, s1, _ in steps) / n / 1e3
    parts = {part: by_part.get(part, 0.0) / n / 1e3
             for part in (*PARTS.values(), "other")}
    busy_ms = busy / n / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n, "wall_ms_per_step": wall,
            "device_ms_per_step": parts,
            "device_busy_ms_per_step": busy_ms,
            "device_ms_by_family": {fam: by_family.get(fam, 0.0) / n / 1e3
                                    for fam, _ in FAMILIES},
            "device_idle_share": 1.0 - busy_ms / wall if wall else None,
            "top_device": [{"name": k, "ms_per_step": v / n / 1e3}
                           for k, v in top],
            "host_api_per_step": {
                k: {"calls": c / n, "ms": d / n / 1e3} for k, (c, d) in
                sorted(runtime.items(), key=lambda kv: -kv[1][1])[:8]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="8b", choices=["tiny", "400m", "8b"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--trace", default="",
                    help="split this trace instead of running the worker")
    args = ap.parse_args()
    if args.trace:
        path = args.trace
    else:
        import torch
        if not torch.cuda.is_available():
            print("torch_profile_distill: CUDA is not available",
                  file=sys.stderr)
            return 1
        path = run_worker(args)
    with open(path, encoding="utf-8") as f:
        line = {"profile": "distill step", "preset": args.preset,
                "batch": args.batch, "seq": args.seq, "trace": path,
                **split(json.load(f))}
    if not args.trace:
        line["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
