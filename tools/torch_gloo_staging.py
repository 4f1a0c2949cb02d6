#!/usr/bin/env python3
"""Time the parts of one fp32 all-reduce between two ranks that share a
card over gloo (``parallel/mesh.py``'s staged path): the device-to-host
copy into pageable and into pinned memory, the gloo all-reduce itself,
and the host-to-device copy back, at 0.1, 1 and 5.1 GB (5.1 GB is the
flat gradient buffer of phase 16c's 8B-width draft).

    python3 tools/torch_gloo_staging.py

Needs a CUDA card; prints one JSON object a rank.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SIZES_GB = (0.1, 1.0, 5.1)


def rank() -> dict:
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec
    dev = MeshSpec(dp=2).build("cuda").device
    out = {}
    for gb in SIZES_GB:
        n = int(gb * 1e9 / 4)
        x = torch.randn(n, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = x.cpu()
        out[f"{gb} d2h_pageable"] = time.perf_counter() - t
        pinned = torch.empty(n, pin_memory=True)
        t = time.perf_counter()
        pinned.copy_(x)
        out[f"{gb} d2h_pinned"] = time.perf_counter() - t
        dist.barrier()
        t = time.perf_counter()
        dist.all_reduce(host)
        out[f"{gb} gloo"] = time.perf_counter() - t
        for name, src in (("pageable", host), ("pinned", pinned)):
            t = time.perf_counter()
            src.to(dev)
            torch.cuda.synchronize()
            out[f"{gb} h2d_{name}"] = time.perf_counter() - t
        del x, host, pinned
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    for r in launch_local(rank, 2, timeout_s=600):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
