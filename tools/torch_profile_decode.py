#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's paged engine spends its time
on the GPU.

    python3 tools/torch_profile_decode.py

Builds Llama-3-8B (random bf16 weights from seed 0, ``max_seq`` 2048),
prefills 8 streams of ragged length through ``PagedServer(slots=8,
page_size=64, prefill_chunk=64)``, then runs 8 decode steps
(window 1) under ``torch.profiler`` and prints one JSON line: the host
wall time per step, the device busy time per step (the sum of the kernel
and copy time the profiler saw), the device idle share, and the kernels
that take the most device time. If the profiler records no device time,
the device numbers are null. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STEPS = 8


def _device_us(event) -> float:
    """Device time of a kernel or copy event; 0 for the host ops that
    launched them (they report their kernels' time as their own too)."""
    from torch.autograd import DeviceType
    if event.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_decode: CUDA is not available", file=sys.stderr)
        return 1
    from dcos_commons_tpu_torch.models import llama, serving

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, device=dev)
    rng = np.random.default_rng(1)
    srv.submit_many([
        {"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
         "max_new": 200, "request_id": i}
        for i, n in enumerate((1, 63, 64, 65, 700, 1500, 1300, 333))])
    while srv._prefill_q or srv._pending_first:
        srv.step()
    for _ in range(2):                                  # warm
        srv.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    top = sorted(events, key=_device_us, reverse=True)[:12]
    step_ms = wall / STEPS * 1e3
    busy_ms = busy_us / STEPS / 1e3 if busy_us else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "profile": "paged decode step", "layers": cfg.n_layers,
        "batch": 8, "steps": STEPS, "wall_ms_per_step": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
        "device_events_per_step": sum(e.count for e in events
                                      if _device_us(e)) / STEPS,
        "top_device": [{"name": e.key[:80], "count": e.count,
                        "ms_per_step": _device_us(e) / STEPS / 1e3}
                       for e in top if _device_us(e)],
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
