#!/usr/bin/env python3
"""Kernel 3, the flash-attention forward, alone on one NVIDIA GPU, beside
other versions of its source.

    python3 tools/torch_bench_flash_fwd.py [--variant SRC.cu ...]

Builds ``dcos_commons_tpu_torch/csrc/flash_attention_fwd.cu`` and each
``--variant`` (a CUDA source exporting the same ``flash_attention_fwd_launch``
and ``flash_attention_fwd_error_string``: an earlier or a candidate version
of the kernel, or one with a planted fault) through the port's build, all
at once. Then, for the committed kernel, each variant in the order given,
and the committed kernel again, a child process with a time limit holds
the kernel against ``flash_attention_reference`` with ``chip_smoke.py``'s
check (``fa_check``) at the forward cases of ``tests/test_torch_cuda.py``
and at ``chip_smoke.py``'s forward shapes, and times it at the latter
beside SDPA's forward and the card's bound; the first child also times the
plain version.

Prints one JSON line per child (the source, its ptxas register lines, each
case's error and its share of the limit, the times and the share of the
bound, or the error that stopped it) and, last, the card's name and power
limit. Exits non-zero if a build, a launch or a check fails. Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHILD_TIMEOUT_S = 120


def _launcher(source: str):
    """Calls ``source``'s C entry point as the port's wrapper does."""
    import torch
    from dcos_commons_tpu_torch.kernels import build
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    lib = build.load(source, fa._FWD_SIGNATURES)

    def run(q, k, v, causal=True, q_offset=0):
        b, s_q, h, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s_q, k.shape[1], h, k.shape[2], d,
            float(d ** -0.5), int(causal), int(q_offset),
            torch.cuda.current_stream().cuda_stream)
        if err:
            msg = lib.flash_attention_fwd_error_string(err).decode()
            raise RuntimeError(f"launch failed ({err}: {msg})")
        return o, lse

    return run


def _check(run, case, q, k, v) -> dict:
    """{case, max_abs_err, err_share_of_limit, lse_max_abs_err} of one
    case against the plain version; raises outside the limits."""
    import torch
    import chip_smoke as cs
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    causal, off = case[-2:]
    o, lse = run(q, k, v, causal, off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal,
                                                  q_offset=off)
    torch.cuda.synchronize()
    err, share = cs.fa_check(f"flash_attention_fwd {case}", o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    if lse_err > cs.LSE_ATOL:
        raise RuntimeError(f"flash_attention_fwd {case}: lse off by "
                           f"{lse_err:.3e}")
    return {"case": list(case), "max_abs_err": err,
            "err_share_of_limit": share, "lse_max_abs_err": lse_err}


def child(source: str, plain: bool) -> dict:
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import FA_CASES, _fa_case

    torch.backends.cuda.matmul.allow_tf32 = False
    run = _launcher(source)
    # the card tests' forward cases, on the card tests' inputs
    edge = [_check(run, case, *_fa_case("cuda", *case[:6])[:3])
            for case in FA_CASES]
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    shapes = []
    for shape in cs.FA_SHAPES + cs.FA_FWD_SHAPES:
        label, b, s, h, kv, d = shape
        q, k, v, _ = cs.fa_inputs(shape)
        checked = _check(run, (b, s, s, h, kv, d, True, 0), q, k, v)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cs.timed_ms(lambda: run(q, k, v), 20, flush)
        lib_ms = cs.timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
        plain_ms = (cs.timed_ms(lambda: fa.flash_attention_reference(q, k, v),
                                3, flush) if plain else None)
        entry = cs.fa_entry(shape, "fwd", (checked["max_abs_err"],
                                           checked["err_share_of_limit"]),
                            ms, plain_ms, lib_ms)
        entry["bound_share"] = entry["bound_ms"] / ms
        entry["tflops"] = entry["ops"] / ms / 1e9
        shapes.append(entry)
    return {"edge": edge, "shapes": shapes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="another .cu source of the same C entry point")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.plain)), flush=True)
        return 0

    import torch
    import chip_smoke as cs
    from dcos_commons_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("torch_bench_flash_fwd: CUDA is not available",
              file=sys.stderr)
        return 1
    committed = str(build.source_path("flash_attention_fwd"))
    variants = [str(Path(v).resolve()) for v in args.variant]
    build.build_all([committed, *variants])
    ok = True
    for i, src in enumerate([committed, *variants, committed]):
        ptxas = [ln.strip() for ln in build.log_path(src).read_text()
                 .splitlines() if "entry function" in ln
                 or "registers" in ln or "spill" in ln]
        line = {"source": os.path.relpath(src, ROOT), "ptxas": ptxas}
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", src]
                + (["--plain"] if i == 0 else []),
                capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc = None
        if proc is not None and proc.returncode == 0:
            line.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        else:
            ok = False
            line["error"] = (proc.stderr.strip()[-2000:] if proc is not None
                             else f"no result within {CHILD_TIMEOUT_S} s")
        print(json.dumps(line), flush=True)
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
