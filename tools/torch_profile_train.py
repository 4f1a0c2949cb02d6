#!/usr/bin/env python3
"""Where a train step of the PyTorch port spends its time on the GPU.

    python3 tools/torch_profile_train.py

Builds ``llama_400m`` (full width and depth, random bf16 weights from
seed 0) and runs bench.py's headline step through the port: batch 16 x
512 tokens, fused cross-entropy, AdamW (warmup 10, decay 1000). After two
warm-up steps it times three steps split into their phases (forward,
backward, optimizer update) with CUDA events, then profiles three more
under ``torch.profiler``, and prints one JSON line: the host wall time
per step, each phase's time, the device busy time per step (the sum of
the kernel and copy time the profiler saw), the device idle share, the
device time per kernel family (cuBLAS products, the flash-attention
kernels, everything else) and the kernels that take the most device
time. If the profiler records no device time, the device numbers are
null. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STEPS = 3
# kernel-name fragments of each family; the first match wins
FAMILIES = (("flash_attention", ("flash_fwd", "flash_bwd")),
            ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
            ("other", ("",)))


def _family(name: str) -> str:
    low = name.lower()
    return next(fam for fam, keys in FAMILIES
                if any(k in low for k in keys))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_train: CUDA is not available", file=sys.stderr)
        return 1
    from dcos_commons_tpu_torch.models import llama, train
    from tools.torch_profile_decode import _device_us

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama_400m(max_seq=512, remat=False)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (16, 512)).astype(np.int32)).to(dev)
    opt = train.make_optimizer(lr=3e-4, warmup=10, decay_steps=1000)
    state = train.init_opt_state(opt, params)
    step = train.make_train_step(lambda p, b: llama.loss_fn(cfg, p, b), opt)
    for _ in range(2):                                  # warm
        step(params, state, toks)

    # phases: the step's own code, split by CUDA events
    leaves = train._leaves(params)
    phase_ms = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for t in leaves:
            t.requires_grad_(True)
        ev[0].record()
        loss, _ = llama.loss_fn(cfg, params, toks)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        for t in leaves:
            t.requires_grad_(False)
        train.apply_updates(opt, params, list(grads), state)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(phase_ms):
            phase_ms[name] += ev[i].elapsed_time(ev[i + 1]) / STEPS
        del grads, loss
    phased_wall = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(params, state, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    families = {fam: 0.0 for fam, _ in FAMILIES}
    for e in events:
        families[_family(e.key)] += _device_us(e) / STEPS / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:15]
    step_ms = wall / STEPS * 1e3
    busy_ms = busy_us / STEPS / 1e3 if busy_us else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "profile": "llama_400m train step", "batch": 16, "seq": 512,
        "layers": cfg.n_layers, "steps": STEPS,
        "wall_ms_per_step_profiled": step_ms,
        "wall_ms_per_step_phased": phased_wall,
        "phase_ms": phase_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
        "device_events_per_step": sum(e.count for e in events
                                      if _device_us(e)) / STEPS,
        "device_ms_by_family": families if busy_us else None,
        "top_device": [{"name": e.key[:80], "count": e.count / STEPS,
                        "ms_per_step": _device_us(e) / STEPS / 1e3}
                       for e in top if _device_us(e)],
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
