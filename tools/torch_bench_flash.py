#!/usr/bin/env python3
"""The attention kernels alone on one NVIDIA GPU, beside other versions of
their source: kernel 3, the flash-attention forward (``--kernel fwd``),
kernels 4 and 5, the backward pair (``--kernel bwd``), or kernels 1 and
2, the paged and slot-cache flash-decode (``--kernel decode``).

    python3 tools/torch_bench_flash.py [--kernel fwd|bwd|decode] [--variant SRC ...]

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

For ``--kernel decode`` a source is a directory holding both
``flash_decode_paged.cu`` and ``flash_decode_slots.cu`` (and the headers
they include, where they differ from ``csrc/``'s): the committed one is
``dcos_commons_tpu_torch/csrc``, the variants are under
``tools/variants/``. Each child holds both kernels against their plain
versions at the decode cases of ``tests/test_torch_cuda.py``, then runs
``chip_smoke.py``'s decode cases through them (their check, the
second-call and 20-launch bitwise checks, and the times beside SDPA and
the bound). A source of the C interface before the one-launch kernel
(no ``flash_decode_*_abi``) is called as that interface was called.

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

CHILD_TIMEOUT_S = 240
SOURCES = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd",
           "decode": "flash_decode_paged"}
DECODE_KINDS = ("paged", "slots")


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


def _decode_sources(where: str) -> dict:
    """{kind: .cu path} of a decode source directory."""
    return {kind: str(Path(where) / f"flash_decode_{kind}.cu")
            for kind in DECODE_KINDS}


def _c_args(n_ptr_int: str):
    """ctypes argtypes from a pattern: p pointer, i int, f float."""
    import ctypes
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    return [kinds[c] for c in n_ptr_int]


# C signatures of the decode entry points by interface version: 1 is the
# split pass + combine of PR 1-5 (partials allocated by the caller), 2 the
# one-launch kernel with a kept workspace
_DECODE_ARGS = {("paged", 1): "p" * 11 + "i" * 9 + "fp",
                ("slots", 1): "p" * 10 + "i" * 8 + "fp",
                ("paged", 2): "p" * 10 + "i" * 9 + "fp",
                ("slots", 2): "p" * 6 + "ii" + "ppp" + "i" * 8 + "fp"}


def _decode_launcher(src: str, kind: str):
    """``src``'s entry point as ``run(q, k, v, [table,] kv_len)``, called
    as the port's wrapper calls it (version 2) or as PR 5's did (1). A
    ``blocks_per_sm`` or ``max_partials`` file beside the source sets
    that parameter of the plan for it."""
    import ctypes
    import torch
    from dcos_commons_tpu_torch.kernels import build
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.ops.quant import QTensor
    err_fn = f"flash_decode_{kind}_error_string"
    lib = build.load(src, {err_fn: (ctypes.c_char_p, [ctypes.c_int])})
    abi = (getattr(lib, f"flash_decode_{kind}_abi")()
           if hasattr(lib, f"flash_decode_{kind}_abi") else 1)
    def plan_param(name, default):
        path = Path(src).parent / name
        return int(path.read_text()) if path.is_file() else default

    blocks_per_sm = plan_param("blocks_per_sm", fd.BLOCKS_PER_SM)
    max_partials = plan_param("max_partials", fd.MAX_PARTIALS)
    launch = getattr(lib, f"flash_decode_{kind}_launch")
    launch.restype = ctypes.c_int
    launch.argtypes = _c_args(_DECODE_ARGS[(kind, abi)])

    def run(q, k, v, *rest):
        kq, vq, ks, vs = fd._kernel_inputs("bench", q, k, v)
        b, _, h, d = q.shape
        _, s, kvh, _ = kq.shape
        quant, scale = int(isinstance(k, QTensor)), float(d ** -0.5)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "paged":
            table, kv_len = rest
            mp = table.shape[1]
            span = mp * s
        else:
            (kv_len,) = rest
            span = s
        if abi == 1:
            lens = (kv_len if kind == "paged"
                    else fd._lengths(kv_len, b, q.device))
            n_sm = fd._sm_count(q.device)
            want = max(1, -(-4 * n_sm // (b * kvh)))
            if kind == "paged":
                per = max(1, -(-mp // want))
                n_splits, sizes = -(-mp // per), (s, mp, per)
            else:
                split = -(-(-(-s // want)) // 64) * 64
                n_splits, sizes = -(-s // split), (s, split)
            part_m = torch.empty((b, kvh, n_splits, h // kvh),
                                 dtype=torch.float32, device=q.device)
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty((b, kvh, n_splits, h // kvh, d),
                                   dtype=torch.float32, device=q.device)
            ptrs = [q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs]
            if kind == "paged":
                ptrs.append(table.data_ptr())
            err = launch(*ptrs, lens.data_ptr(), out.data_ptr(),
                         part_m.data_ptr(), part_l.data_ptr(),
                         part_acc.data_ptr(), b, h, kvh, d, *sizes,
                         n_splits, quant, scale, stream)
        else:
            plan = fd.decode_plan(b, kvh, h // kvh, d, span,
                                  fd._sm_count(q.device), blocks_per_sm,
                                  max_partials)
            part, counters = fd._workspace(q.device, stream, plan)
            if kind == "paged":
                err = launch(q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks,
                             vs, table.data_ptr(), kv_len.data_ptr(),
                             out.data_ptr(), part.data_ptr(),
                             counters.data_ptr(), b, h, kvh, d, s, mp,
                             plan.max_partials, plan.grid, quant, scale,
                             stream)
            else:
                keep, ptr, stride, value = fd._length_args(kv_len, b)
                err = launch(q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks,
                             vs, ptr, stride, value, out.data_ptr(),
                             part.data_ptr(), counters.data_ptr(), b, h,
                             kvh, d, s, plan.max_partials, plan.grid, quant,
                             scale, stream)
        if err:
            _raise(lib, err_fn, err)
        return out

    return run


def _decode_child(where: str, plain: bool) -> dict:
    import torch
    import chip_smoke as cs
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import CASES, SLOT_CASES, _case, _slot_case

    srcs = _decode_sources(where)
    paged = _decode_launcher(srcs["paged"], "paged")
    slots = _decode_launcher(srcs["slots"], "slots")
    errors, edge = [], []

    def attempt(label, fn):
        try:
            return fn()
        except RuntimeError as e:      # a check that failed: report, go on
            errors.append(f"{label}: {e}")
            return None

    # the card tests' cases, on the card tests' inputs
    for case in CASES:
        q, k, v, table, lens = _case("cuda", *case)
        got = attempt(f"paged {case}", lambda: cs.decode_check(
            f"paged {case}", paged(q, k, v, table, lens),
            fd.flash_decode_paged_reference(q, k, v, table, lens), case[6]))
        edge.append({"kernel": "paged", "case": list(case),
                     "max_abs_err": got})
    for case in SLOT_CASES:
        b, h, kv, d, s, kv_len, int8 = case
        q, k, v = _slot_case("cuda", b, h, kv, d, s, int8)
        lens = (kv_len if isinstance(kv_len, int) else
                torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
        per_row = [kv_len] * b if isinstance(kv_len, int) else kv_len
        got = attempt(f"slots {case}", lambda: cs.decode_check(
            f"slots {case}", slots(q, k, v, lens),
            fd.flash_decode_reference(q, k, v, lens), per_row))
        edge.append({"kernel": "slots", "case": list(case),
                     "max_abs_err": got})
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    shapes = []
    def timed_only(kind, run, *inputs):
        """The time of a version whose check failed (a planted fault):
        shown beside the error, never as a result."""
        return {"kernel": kind, "failed": True,
                "ms": cs.timed_ms(lambda: run(*inputs), 50, flush)}

    for ps, int8 in cs.PAGED_CASES:
        entry = attempt(f"paged ps={ps} int8={int8}",
                        lambda: cs.flash_decode_case(ps, int8, flush, paged,
                                                     plain))
        shapes.append(entry or dict(timed_only("paged", paged, *cs.decode_inputs(
            "paged", int8, cs.KV_LENS, cs.SEED + ps + int8, ps)),
            page_size=ps, int8=int8))
    for int8, lens in cs.SLOT_CASES:
        entry = attempt(f"slots int8={int8} {lens}",
                        lambda: cs.slot_decode_case(int8, lens, flush, slots,
                                                    plain))
        shapes.append(entry or dict(timed_only("slots", slots, *cs.decode_inputs(
            "slots", int8, lens, cs.SEED + 7 + int8)), int8=int8,
            kv_len=list(lens)))
    # the floor of any timed call: one launch of a one-element fill
    one = torch.empty(1, device="cuda")
    floor_ms = cs.timed_ms(lambda: one.fill_(1.0), 50, flush)
    return {"edge": edge, "shapes": shapes, "errors": errors,
            "launch_floor_ms": floor_ms}


def child(kernel: str, source: str, plain: bool) -> dict:
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import FA_CASES, _fa_case

    torch.backends.cuda.matmul.allow_tf32 = False
    if kernel == "decode":
        return _decode_child(source, plain)
    fn = _fwd_child if kernel == "fwd" else _bwd_child
    return fn(source, plain, FA_CASES, _fa_case)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="fwd",
                    help="fwd: kernel 3; bwd: kernels 4 and 5; decode: "
                         "kernels 1 and 2")
    ap.add_argument("--variant", action="append", default=[],
                    help="another .cu source of the same C entry points "
                         "(decode: a directory of both sources)")
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
    variants = [str(Path(v).resolve()) for v in args.variant]
    if args.kernel == "decode":
        committed = str(build.CSRC)
        build.build_all([src for where in [committed, *variants]
                         for src in _decode_sources(where).values()])
    else:
        committed = str(build.source_path(SOURCES[args.kernel]))
        build.build_all([committed, *variants])
    ok = True
    for i, src in enumerate([committed, *variants, committed]):
        logs = (_decode_sources(src).values() if args.kernel == "decode"
                else [src])
        ptxas = [ln.strip() for log in logs
                 for ln in build.log_path(log).read_text().splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
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
            ok = ok and not line.get("errors")
        else:
            ok = False
            line["error"] = (proc.stderr.strip()[-2000:] if proc is not None
                             else f"no result within {CHILD_TIMEOUT_S} s")
        print(json.dumps(line), flush=True)
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
