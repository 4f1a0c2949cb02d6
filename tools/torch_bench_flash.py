#!/usr/bin/env python3
"""The flash-attention kernels alone on one NVIDIA GPU, beside other
versions of their source: kernel 3, the forward (``--kernel fwd``), or
kernels 4 and 5, the backward pair (``--kernel bwd``).

    python3 tools/torch_bench_flash.py [--kernel fwd|bwd] [--variant SRC.cu ...]

Builds the committed source (``dcos_commons_tpu_torch/csrc/
flash_attention_fwd.cu`` or ``flash_attention_bwd.cu``) and each
``--variant`` (a CUDA source exporting the same C entry points: an earlier
or a candidate version of the kernels, or one with a planted fault)
through the port's build, all at once. Then, for the committed source,
each variant in the order given, and the committed source again, a child
process with a time limit holds the kernels against their plain versions
with ``chip_smoke.py``'s check (``fa_check``) at the flash-attention cases
of ``tests/test_torch_cuda.py`` and at ``chip_smoke.py``'s shapes, and
times them at the latter beside SDPA and the card's bound; the first child
also times the plain versions. For the backward it also times the port's
whole backward (the rowsum pass and both kernels) beside SDPA's, and
checks that 20 launches at the train shape give bitwise-equal gradients.

Prints one JSON line per child (the source, its ptxas register lines, each
case's error and its share of the limit, the times and the shares of the
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

CHILD_TIMEOUT_S = 180
SOURCES = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd"}


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def _raise(lib, fn: str, err: int) -> None:
    msg = getattr(lib, fn)(err).decode()
    raise RuntimeError(f"launch failed ({err}: {msg})")


def _fwd_launcher(source: str):
    """Calls ``source``'s forward entry point as the port's wrapper does."""
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
            float(d ** -0.5), int(causal), int(q_offset), _stream())
        if err:
            _raise(lib, "flash_attention_fwd_error_string", err)
        return o, lse

    return run


def _bwd_launchers(source: str):
    """(dkdv, dq): ``source``'s backward entry points, called as the
    port's wrappers call them."""
    import torch
    from dcos_commons_tpu_torch.kernels import build
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    lib = build.load(source, fa._BWD_SIGNATURES)

    def dims(q, k, sm_scale, causal, q_offset):
        b, s_q, h, d = q.shape
        scale = d ** -0.5 if sm_scale is None else sm_scale
        return (b, s_q, k.shape[1], h, k.shape[2], d, float(scale),
                int(causal), int(q_offset), _stream())

    def dkdv(q, k, v, do, lse, delta, causal=True, q_offset=0,
             sm_scale=None):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.flash_attention_bwd_dkdv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims(q, k, sm_scale, causal, q_offset))
        if err:
            _raise(lib, "flash_attention_bwd_error_string", err)
        return dk, dv

    def dq(q, k, v, do, lse, delta, causal=True, q_offset=0, sm_scale=None):
        out = torch.empty_like(q)
        err = lib.flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
            *dims(q, k, sm_scale, causal, q_offset))
        if err:
            _raise(lib, "flash_attention_bwd_error_string", err)
        return out

    return dkdv, dq


def _fwd_check(run, case, q, k, v) -> dict:
    """{case, max_abs_err, err_share_of_limit, lse_max_abs_err} of one
    forward case against the plain version; raises outside the limits."""
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


def _bwd_check(dkdv, dq, case, q, k, v, do) -> dict:
    """{case, and per gradient its max abs error and share of the limit}
    of one backward case against the plain versions, from the plain
    forward's lse; raises outside the limits."""
    import torch
    import chip_smoke as cs
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    causal, off = case[-2:]
    kw = dict(causal=causal, q_offset=off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, **kw)
    delta = fa.attention_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta)
    got = (dq(*args, **kw), *dkdv(*args, **kw))
    want = (fa.flash_attention_bwd_dq_reference(*args, **kw),
            *fa.flash_attention_bwd_dkdv_reference(*args, **kw))
    torch.cuda.synchronize()
    out = {"case": list(case)}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, share = cs.fa_check(f"flash_attention_bwd {name} {case}", g, w,
                                 rows=False)
        out[name] = {"max_abs_err": err, "err_share_of_limit": share}
    return out


def _fwd_child(source: str, plain: bool, cases, fa_case) -> dict:
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    run = _fwd_launcher(source)
    # the card tests' cases, on the card tests' inputs
    edge = [_fwd_check(run, case, *fa_case("cuda", *case[:6])[:3])
            for case in cases]
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    shapes = []
    for shape in cs.FA_SHAPES + cs.FA_FWD_SHAPES:
        label, b, s, h, kv, d = shape
        q, k, v, _ = cs.fa_inputs(shape)
        checked = _fwd_check(run, (b, s, s, h, kv, d, True, 0), q, k, v)
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


def _bwd_child(source: str, plain: bool, cases, fa_case) -> dict:
    import torch
    import chip_smoke as cs
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    dkdv, dq = _bwd_launchers(source)
    edge = [_bwd_check(dkdv, dq, case, *fa_case("cuda", *case[:6]))
            for case in cases]
    # run to run: a stage handed back before its last reader completed
    # shows up as gradients that differ between launches
    q, k, v, do = cs.fa_inputs(cs.FA_SHAPES[0])
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v)
    args = (q, k, v, do, lse_ref, fa.attention_delta(o_ref, do))
    first = (dq(*args), *dkdv(*args))
    for _ in range(19):
        again = (dq(*args), *dkdv(*args))
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise RuntimeError("flash_attention_bwd: gradients differ "
                               "between launches on the same inputs")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    shapes = []
    for shape in cs.FA_SHAPES:
        for entry in cs.flash_attention_bwd_case(shape, flush, dkdv, dq,
                                                 plain):
            entry["tflops"] = entry["ops"] / entry["ms"] / 1e9
            shapes.append(entry)
    return {"edge": edge, "bitwise_equal_launches": 20, "shapes": shapes}


def child(kernel: str, source: str, plain: bool) -> dict:
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import FA_CASES, _fa_case

    torch.backends.cuda.matmul.allow_tf32 = False
    fn = _fwd_child if kernel == "fwd" else _bwd_child
    return fn(source, plain, FA_CASES, _fa_case)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="fwd",
                    help="fwd: kernel 3; bwd: kernels 4 and 5")
    ap.add_argument("--variant", action="append", default=[],
                    help="another .cu source of the same C entry points")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.kernel, args.child, args.plain)),
              flush=True)
        return 0

    import torch
    import chip_smoke as cs
    from dcos_commons_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("torch_bench_flash: CUDA is not available", file=sys.stderr)
        return 1
    committed = str(build.source_path(SOURCES[args.kernel]))
    variants = [str(Path(v).resolve()) for v in args.variant]
    build.build_all([committed, *variants])
    ok = True
    for i, src in enumerate([committed, *variants, committed]):
        ptxas = [ln.strip() for ln in build.log_path(src).read_text()
                 .splitlines() if "entry function" in ln
                 or "registers" in ln or "spill" in ln]
        line = {"kernel": args.kernel, "source": os.path.relpath(src, ROOT),
                "ptxas": ptxas}
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--kernel", args.kernel,
                 "--child", src] + (["--plain"] if i == 0 else []),
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
