#!/usr/bin/env python3
"""Where a decode step of one of the PyTorch port's engines spends its time
on the GPU, graphed and eager.

    python3 tools/torch_profile_decode.py [--engine paged|slots|spec|moe]

Builds Llama-3-8B (random bf16 weights from seed 0, ``max_seq`` 2048),
prefills 8 streams of ragged length through ``PagedServer(slots=8,
page_size=64, prefill_chunk=64)`` (``--engine paged``, the default) or
``SlotServer(slots=8)`` (``--engine slots``), then profiles windows of 8
decode steps two ways from the same state: ``step_many(8)``, which
replays the engine's CUDA graph of the window, and the eager
model-function loop driven by hand (``chip_smoke.eager_loop``: the
engines' path before graphs) on clones of the cache or pool. For each it prints one JSON line: the host wall time
per step (profiled and, before the profiler starts, unprofiled), the
device busy time per step (the sum of the kernel and copy time the
profiler saw), the device idle share, the decode attention kernels' time
and count per step, the ``cudaLaunchKernel`` and ``cudaGraphLaunch``
calls per step, the kernels that take the most device time and the host
ops that take the most host time. If the profiler records no device
time, the device numbers are null.

``--engine spec`` arms the paged engine with the 1-layer truncated draft
at k=4 (``chip_smoke.DRAFT_LAYERS``/``SPEC_K``), prefills the same 8
streams through spec windows, and profiles spec windows the same two
ways (``step_many``, one graph a window, and ``chip_smoke.
spec_eager_loop``), a "step" being a window. Then it splits a window's
device time: the k draft steps, the K-wide verify, the verify's page
gather and dense attention alone (every layer's, at the window's table
width), and the acceptance, each captured as its own CUDA graph on
clones of the engine's state and timed over replays with CUDA events
(``chip_smoke.spec_split``).

``--engine moe`` builds the MoE model instead (Llama-3-8B widths and
depth, 8 experts top-2, dropless: ``llama.init_moe_params`` from seed 0,
about 65 GB) behind ``PagedServer(moe=...)``, profiles its windows the
same two ways, and splits a graphed step's device time
(``chip_smoke.moe_split``): routing, the dispatch and combine products,
the expert products, the casts and kernel 1, each captured as its own
CUDA graph, and the rest of the step. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

K = 8           # steps a window
WINDOWS = 3     # profiled windows a mode


def _device_us(event) -> float:
    """Device time of a kernel or copy event; 0 for the host ops that
    launched them (they report their kernels' time as their own too)."""
    from torch.autograd import DeviceType
    if event.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _profile(window, label, engine, layers, card, k=K) -> dict:
    """One mode's line; ``window()`` runs ``k`` steps (a spec window
    counts as one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):                                  # warm
        window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WINDOWS):
        window()
    unprofiled = (time.perf_counter() - t0) / (WINDOWS * k) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOWS):
            window()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = WINDOWS * k
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    top = sorted(events, key=_device_us, reverse=True)[:12]
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:12]
    step_ms = wall / steps * 1e3
    busy_ms = busy_us / steps / 1e3 if busy_us else None
    decode = [e for e in events if _device_us(e)
              and "decode_kernel" in e.key]

    def calls(name):
        return sum(e.count for e in events if e.key.startswith(name)) / steps

    return {
        "profile": f"{engine} decode, {label}", "layers": layers,
        "batch": 8, "window": k, "steps": steps,
        "wall_ms_per_step": step_ms,
        "unprofiled_wall_ms_per_step": unprofiled,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
        "decode_kernel_ms_per_step": sum(_device_us(e) for e in decode)
        / steps / 1e3,
        "decode_kernels_per_step": sum(e.count for e in decode) / steps,
        "launch_kernel_calls_per_step": calls("cudaLaunchKernel"),
        "graph_launch_calls_per_step": calls("cudaGraphLaunch"),
        "device_events_per_step": sum(e.count for e in events
                                      if _device_us(e)) / steps,
        "top_device": [{"name": e.key[:80], "count": e.count,
                        "ms_per_step": _device_us(e) / steps / 1e3}
                       for e in top if _device_us(e)],
        "top_host": [{"name": e.key[:80], "count": e.count,
                      "self_ms_per_step": e.self_cpu_time_total / steps / 1e3}
                     for e in top_host],
        "card": card}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("paged", "slots", "spec", "moe"),
                    default="paged")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_decode: CUDA is not available", file=sys.stderr)
        return 1
    from dcos_commons_tpu_torch.models import llama, serving

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    if args.engine == "moe":
        from chip_smoke import MOE_EXPERTS
        from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless
        params = llama.init_moe_params(
            cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(0),
            device=dev)
        srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                                  prefill_chunk=64,
                                  moe=dropless(MoEConfig(MOE_EXPERTS)),
                                  device=dev)
    else:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if args.engine in ("paged", "spec"):
        srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                                  prefill_chunk=64, device=dev)
    elif args.engine == "slots":
        srv = serving.SlotServer(cfg, params, slots=8, device=dev)
    if args.engine == "spec":
        from chip_smoke import DRAFT_LAYERS, SPEC_K
        srv.arm_draft(*llama.truncate_layers(cfg, params, DRAFT_LAYERS),
                      k=SPEC_K)
    rng = np.random.default_rng(1)
    srv.submit_many([
        {"prompt": [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
         "max_new": 400, "request_id": i}
        for i, n in enumerate((1, 63, 64, 65, 700, 1500, 1300, 333))])
    while getattr(srv, "_prefill_q", None) or srv._pending_first:
        # armed, step_many(1) keeps the draft cache in step
        srv.step_many(1) if args.engine == "spec" else srv.step()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from chip_smoke import eager_loop, moe_split, spec_eager_loop, spec_split
    split = None
    if args.engine == "moe":
        split = {"profile": "moe step split", **moe_split(srv), "card": card}
    if args.engine == "spec":
        split = {"profile": "spec window split", **spec_split(srv),
                 "card": card}
        k = 1                                 # a "step" is a window
        eager, _ = spec_eager_loop(srv)
        graphed = lambda: srv.step_many(srv.draft_k)   # noqa: E731
    else:
        k = K
        eager, _ = eager_loop(srv, K)
        graphed = lambda: srv.step_many(K)             # noqa: E731
    lines = [_profile(eager, "eager loop", args.engine, cfg.n_layers, card,
                      k),
             _profile(graphed, "CUDA graph", args.engine, cfg.n_layers,
                      card, k)]
    if split is not None:
        lines.append(split)
    lines[1]["graphs"] = {k: v for k, v in srv.graph_stats().items()
                          if k != "keys"}
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
