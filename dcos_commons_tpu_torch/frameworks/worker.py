"""Task-side worker of the port: what a scheduled pod instance runs (port
of ``frameworks/jax/worker.py``: its ``llama``, ``llama-train`` and
``distill`` workloads).

    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset tiny
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 [--pages 64] [--quant int8] [--kv-quant] \\
        [--spec-decode true --draft-checkpoint DIR --draft-k 4] [--out VOL]
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 --pages -1 --moe-experts 8 --moe-capacity-factor 0
    python -m dcos_commons_tpu_torch.frameworks.worker llama-train \\
        --steps 20 --seq 256 [--ckpt-every N] [--grad-accum N] --out VOL
    python -m dcos_commons_tpu_torch.frameworks.worker distill --preset 8b \\
        --draft-layers 1 --batch 32 --seq 256 --steps 20 --out VOL

Flags keep the reference's names, defaults and env knobs; ``--device``
(default ``cuda``) is the one new flag, the counterpart of the
reference's ``JAX_PLATFORMS`` handling. The scheduler's rank contract
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_PROCESS_ID`` /
``JAX_NUM_PROCESSES``) is read by ``parallel.distributed``, so the
scheduler needs no edit. Every event is one JSON line on stdout.

``--serve --slots N`` serves behind the HTTP front door
(``models.ingress.ServingFrontend``): ``SlotServer`` by default,
``PagedServer`` with ``--pages`` (warmed up, its decode windows captured
as CUDA graphs, with the process-wide compile cache of
``parallel.aot``). Without ``--slots`` it keeps the solo heartbeat
decode. ``serving.ready`` in the working directory is the readiness
marker, re-stamped with the port once the front door listens.

``--moe-experts E`` (with ``--pages``) serves a mixture-of-experts model:
random bf16 expert banks from seed 0 (``llama.init_moe_params``; no
checkpoint restore, as in the reference), routed by
``--moe-routing`` with ``--moe-capacity-factor`` (0 = dropless), the
timed decode through ``llama.generate_stepwise_moe``. Without
``--pages``, or with ``--quant``/``--kv-quant``, it serves dense with a
coded ``moe_fallback`` (the reference's codes); with
``--prefill-seq-parallel`` MoE wins and ``longctx_fallback`` says so.

``--spec-decode true --draft-checkpoint DIR`` arms the paged engine with
a sealed draft artifact (``models.speculative.save_draft``): a
``spec_armed`` event, or a coded ``spec_fallback`` (the reference's
codes) and solo serving. A serving worker whose ``--out`` holds a
sharded checkpoint (``parallel.checkpoint``) restores its weights from
it (``weights_loaded`` with ``source`` ``disk``), or emits
``weight_restore_fallback`` and serves the init.

``llama-train`` trains the tiny Llama on one device under the fault
sentinel (``frameworks.sentinel``: SIGTERM flush and exit 143, NaN
rollback, stall watchdog), with sharded ``{"params", "opt_state"}``
checkpoints in the reference's layout and automatic resume from
``--out``. ``distill`` trains a draft (the target's first
``--draft-layers`` layers, copied) against the frozen target that
``llama --serve`` builds from the same preset and seed, through the
fused linear-KL head, and seals it under ``--out/draft`` for
``--spec-decode``. ``--profile-dir`` (or ``TPU_PROFILE_DIR``) wraps the
workload in ``torch.profiler`` and writes a Chrome trace there.

What is not ported yet refuses loudly, never runs without it: a knob of
a module still to port exits 2 with a coded ``error`` event naming its
ROADMAP Queue 1 item (peer weights: item 6; gangs and expert-parallel
MoE training: item 7; pipelines, ring prefill and ring or Ulysses
attention: item 9;
disaggregation, the router, KV tiers, the prefix directory and live
resharding: item 10). The weight server is an accelerant in the
reference, so asking for it only emits ``weight_server_error``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import torch


class NotPorted(Exception):
    """A requested feature whose module is not ported yet: the worker
    exits 2 with ``code``."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _emit(record: dict) -> None:
    """One JSON line per progress event."""
    print(json.dumps(record), flush=True)


def yaml_bool(value) -> bool:
    """Spec booleans arrive as strings ('true'/'false'), as the
    scheduler renders them."""
    if isinstance(value, str):
        return value.strip().lower() in ("true", "yes", "1")
    return bool(value)


def _refuse_unported(args) -> None:
    """Raise :class:`NotPorted` for a serving knob whose module is not
    ported yet."""
    if not args.serve:
        return
    role = args.serve_role
    if role == "router":
        raise NotPorted("router_not_ported", "--serve-role router: the "
                        "fleet router (models/router.py) is not ported "
                        "yet (ROADMAP Queue 1 item 10)")
    if role != "colocated":
        raise NotPorted("disagg_not_ported", f"--serve-role {role}: "
                        "disaggregated prefill/decode tiers are not "
                        "ported yet (ROADMAP Queue 1 item 10)")
    disk = args.kv_tier_disk_pages if args.kv_tier_disk_dir else 0
    if args.kv_tier_host_pages > 0 or disk > 0:
        raise NotPorted("kv_tiers_not_ported", "--kv-tier-*: host and "
                        "disk KV tiers are not ported yet (ROADMAP Queue 1 "
                        "item 10)")
    if args.prefix_directory > 0:
        raise NotPorted("prefix_directory_not_ported", "--prefix-directory:"
                        " the fleet prefix directory is not ported yet "
                        "(ROADMAP Queue 1 item 10)")


def _serving_arithmetic(args):
    """The MoE config ``--moe-experts`` asks for, or None for the dense
    stack, with the reference's coded events: MoE serves through the
    paged engine only (``moe_fallback`` ``moe_needs_paged``), and on raw
    bf16 expert banks (``moe_quant``), else the replica serves dense.
    ``--prefill-seq-parallel`` with MoE emits ``longctx_fallback``
    ``longctx_with_moe`` (MoE wins, prefill stays chunked); without MoE
    ring prefill is refused, since it is not ported. Capacity is
    ``--moe-capacity-factor`` (1.0 when unset), dropless when it is <= 0.
    On one device the reference's mesh is ``ep=1``: the local path."""
    from ..parallel.moe import MoEConfig, dropless
    moe_cfg = None
    if args.moe_experts > 0:
        if not args.pages:
            _emit({"event": "moe_fallback", "code": "moe_needs_paged",
                   "error": "MoE serving routes through the paged "
                            "engine only: set --pages/SERVE_PAGES "
                            "(serving dense)"})
        elif args.quant != "none" or args.kv_quant:
            _emit({"event": "moe_fallback", "code": "moe_quant",
                   "error": "MoE expert banks serve raw bf16 "
                            "(quantize_params rejects router trees); "
                            "drop --quant/--kv-quant (serving dense)"})
        else:
            moe_cfg = MoEConfig(args.moe_experts,
                                capacity_factor=args.moe_capacity_factor
                                or 1.0,
                                routing=args.moe_routing)
            if args.moe_capacity_factor <= 0:
                moe_cfg = dropless(moe_cfg)
    if yaml_bool(args.prefill_seq_parallel):
        if moe_cfg is None:
            raise NotPorted("longctx_not_ported", "--prefill-seq-parallel: "
                            "ring prefill is not ported yet (ROADMAP Queue "
                            "1 item 9)")
        _emit({"event": "longctx_fallback", "code": "longctx_with_moe",
               "error": "one replica mesh carries ep OR sp; MoE decode "
                        "wins, prefill stays chunked"})
    return moe_cfg


def _boot_serving_weights(args, template, init, registry=None):
    """Serving weights from, in the reference's order, a sibling's weight
    server (``WEIGHT_FETCH_PEERS``: not ported, refused, since serving
    the init in its place would be a different result), the newest
    sharded checkpoint under ``--out`` restored into ``template`` (a tree
    of uninitialised tensors, so the device never holds the weights
    twice), or ``init()``. A checkpoint that fails its restore (pruned or
    corrupt shards) falls through to the init with a
    ``weight_restore_fallback`` event. The restore's seconds land in the
    registry and the returned report, as in the reference."""
    from ..parallel import checkpoint as ckpt
    if any(p.strip() for p in
           os.environ.get("WEIGHT_FETCH_PEERS", "").split(",")):
        raise NotPorted("weight_fetch_not_ported", "WEIGHT_FETCH_PEERS: "
                        "peer weight fetch (models/weights.py) is not "
                        "ported yet (ROADMAP Queue 1 item 6)")
    report = {"source": "init", "fetch_s": 0.0, "restore_s": 0.0}
    step = ckpt.latest_step(args.out) if args.out else None
    if step is not None:
        try:
            t0 = time.perf_counter()
            params = ckpt.restore_sharded(args.out, template, step)
            dt = time.perf_counter() - t0
            report["restore_s"] = round(dt, 4)
            if registry is not None:
                registry.observe("autoscale.cold_start.restore_seconds", dt)
            report["source"] = "disk"
            report["step"] = step
            return params, report
        except (FileNotFoundError, ckpt.CheckpointCorrupt) as e:
            _emit({"event": "weight_restore_fallback", "error": str(e),
                   "step": step})
    return init(), report


def _start_weight_server(args) -> None:
    """The weight server is an accelerant in the reference: asking for it
    emits ``weight_server_error`` and serving goes on."""
    port = (os.environ.get("WEIGHT_SERVE_PORT")
            or os.environ.get("PORT_WEIGHTS"))
    if args.out and port is not None:
        _emit({"event": "weight_server_error",
               "error": "the weight server (models/weights.py) is not "
                        "ported yet (ROADMAP Queue 1 item 6)"})


def _make_serving_engine(args, cfg, params, device, registry=None,
                         moe=None):
    """``PagedServer`` with ``--pages`` (sharing the process-wide compile
    cache; ``moe`` from :func:`_serving_arithmetic`), ``SlotServer``
    otherwise. A paged config the model cannot satisfy falls back to the
    slot engine with a ``paged_fallback`` event, as in the reference;
    an MoE model, which the slot engine cannot serve, raises after the
    event instead of serving a replica that fails its first request.
    ``--spec-decode`` arms the paged engine (:func:`_arm_spec_decode`);
    without one it emits ``spec_fallback`` with ``spec_needs_paged`` and
    serves solo."""
    from ..models.serving import PagedServer, SlotServer
    from ..parallel import aot
    spec_wanted = yaml_bool(args.spec_decode)
    if args.pages:
        try:
            engine = PagedServer(
                cfg, params, slots=args.slots,
                pages=None if args.pages < 0 else args.pages,
                page_size=args.page_size,
                prefill_chunk=args.prefill_chunk,
                compile_cache=aot.from_env(), moe=moe, device=device)
            if spec_wanted:
                _arm_spec_decode(args, cfg, engine, registry)
            return engine, engine.page_stats()
        except ValueError as e:
            _emit({"event": "paged_fallback", "error": str(e),
                   "pages": args.pages, "page_size": args.page_size,
                   "prefill_chunk": args.prefill_chunk})
            if moe is not None:
                raise
    if spec_wanted:
        _emit({"event": "spec_fallback", "code": "spec_needs_paged",
               "error": "speculative decode needs the paged engine "
                        "(--pages); serving solo"})
    return SlotServer(cfg, params, slots=args.slots, device=device), None


def _arm_spec_decode(args, cfg, engine, registry) -> None:
    """Load the draft artifact onto the engine's device and arm the paged
    engine, with a coded ``spec_fallback`` on any draft problem: the load
    re-checks the sealed manifest digest (an overwritten artifact reads
    as ``draft_manifest_stale``) and the arm runs the widest window once,
    so what can go wrong goes wrong here, before a request exists."""
    from ..models.speculative import DraftIncompatible, load_draft
    path = args.draft_checkpoint or ""
    if not path:
        _emit({"event": "spec_fallback", "code": "draft_config_missing",
               "error": "--spec-decode without --draft-checkpoint"})
        return
    try:
        t0 = time.perf_counter()
        cfg_d, params_d, meta = load_draft(path, cfg, device=engine.device)
        load_s = time.perf_counter() - t0
        engine.arm_draft(cfg_d, params_d, k=max(2, args.draft_k),
                         metrics=registry)
    except DraftIncompatible as e:
        _emit({"event": "spec_fallback", "code": e.code, "error": str(e),
               "draft_checkpoint": path})
        return
    except Exception as e:  # the arm-time window failed to run
        engine.disarm_draft()
        _emit({"event": "spec_fallback", "code": "draft_arm_failed",
               "error": str(e), "draft_checkpoint": path})
        return
    _emit({"event": "spec_armed", "draft_checkpoint": path,
           "k": engine.draft_k, "draft_layers": cfg_d.n_layers,
           "draft_step": meta.get("step"), "load_s": round(load_s, 4)})


def _nbytes(tree) -> int:
    from ..ops.quant import QTensor
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return _nbytes(tree.q) + _nbytes(tree.s)
    return tree.numel() * tree.element_size()


def _device_report(server) -> dict:
    """Kernel launches so far, captured graphs and peak device memory
    (CUDA only): what a heartbeat adds to the reference's."""
    from ..ops import flash_attention, flash_decode
    if server.device.type != "cuda":
        return {}
    g = server.graph_stats()
    return {"launches": {
                "flash_decode": flash_decode.flash_decode.launches,
                "flash_decode_paged":
                    flash_decode.flash_decode_paged.launches,
                "flash_attention_fwd":
                    flash_attention.flash_attention_fwd.launches},
            "graphs": {"graphs": g["graphs"], "capture_s": g["capture_s"],
                       "pool_bytes": g["pool_bytes"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _target_config(args):
    """The serving target's config from ``--preset``, ``--max-seq`` and
    ``--kv-quant``: what ``llama`` serves and ``distill`` distills from."""
    from ..models import llama
    kv_quant = args.kv_quant
    if args.preset == "8b":
        return llama.LlamaConfig.llama3_8b(max_seq=args.max_seq or 2048,
                                           remat=False, kv_quant=kv_quant)
    if args.preset == "400m":
        return llama.LlamaConfig.llama_400m(max_seq=args.max_seq or 2048,
                                            kv_quant=kv_quant)
    if args.max_seq:
        return llama.LlamaConfig.tiny(max_seq=args.max_seq,
                                      kv_quant=kv_quant)
    return llama.LlamaConfig.tiny(kv_quant=kv_quant)


def _init_target(cfg, dev: torch.device, quant: str = "none"):
    """The serving target's weights, from seed 0: a draft distilled from
    them fits the target ``llama --serve`` builds on the same device."""
    from ..models import llama
    if quant == "int8":
        # init + quantize on the host CPU: no bf16 weight on the device
        return llama.init_quantized_params(
            cfg, torch.Generator().manual_seed(0), device=dev)
    return llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def run_llama(args) -> dict:
    """Llama inference on one device: the solo decode rate, then with
    ``--serve`` a serving loop that never returns while healthy."""
    from .._device import resolve_device
    from ..models import llama
    from ..parallel import distributed

    _refuse_unported(args)
    moe_cfg = _serving_arithmetic(args) if args.serve else None
    contract = distributed.initialize()
    dev = resolve_device(args.device)
    kv_quant = args.kv_quant
    cfg = _target_config(args)
    gen_len = args.gen_len
    # chunked decode for everything but tiny, as in the reference; MoE
    # decodes stepwise (the dense generate paths read the dense FFN)
    chunked = ((args.preset != "tiny" or args.quant != "none")
               and moe_cfg is None)
    # chunked rounds the continuation up to whole chunks before trimming;
    # divide by the EXECUTED token count or tps reads low off-alignment
    exec_len = (1 + -(-(gen_len - 1) // 16) * 16) if chunked else gen_len

    def timed_decode(prompt):
        t0 = time.perf_counter()
        if moe_cfg is not None:
            toks = llama.generate_stepwise_moe(cfg, params, prompt, gen_len,
                                               moe_cfg)
        elif chunked:
            toks = llama.generate_chunked(cfg, params, prompt, gen_len,
                                          chunk=16)
        else:
            toks = llama.generate(cfg, params, prompt, gen_len)
        toks.cpu()
        return round(exec_len / max(time.perf_counter() - t0, 1e-9), 2)

    def init():
        if moe_cfg is not None:
            # raw bf16 expert banks, drawn slab by slab on the device
            return llama.init_moe_params(
                cfg, moe_cfg.num_experts,
                torch.Generator(device=dev).manual_seed(0), device=dev)
        return _init_target(cfg, dev, args.quant)

    registry = None
    boot_report = {"source": "init", "fetch_s": 0.0, "restore_s": 0.0}
    if args.serve:
        from ..metrics import MetricsRegistry
        registry = MetricsRegistry()
    if args.serve and args.quant == "none" and moe_cfg is None:
        params, boot_report = _boot_serving_weights(
            args, llama.param_template(cfg, dev), init, registry)
    else:
        # int8 replicas keep their freshly quantized init, as in the
        # reference: quantized trees are outside the restore template,
        # and so are MoE trees
        params = init()
    if args.serve:
        _emit({"event": "weights_loaded", **boot_report})
    prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=dev)
    timed_decode(prompt)  # warm-up
    tokens_per_sec = timed_decode(prompt)

    if args.out:  # readiness-check gate: the shard is serving
        os.makedirs(args.out, exist_ok=True)
    with open("serving.ready", "w") as f:
        f.write("ok\n")
    result = {"workload": "llama", "preset": args.preset,
              "quant": args.quant, "kv_quant": kv_quant,
              "weight_gb": round(_nbytes(params) / 1e9, 2),
              "tokens_per_sec": tokens_per_sec,
              "tp": 1, "process_id": contract["process_id"]}
    if not args.serve:
        return result
    if args.slots > 0:
        _serve_slots(args, cfg, params, dev, registry, boot_report, result,
                     moe_cfg)
    # no slot engine: the fixed-prompt heartbeat decode keeps the solo
    # liveness signal; slots 0 tells monitoring not to expect batching
    _emit({"event": "serving", "slots": 0,
           "slots_requested": args.slots, **result})
    i = 0
    while True:
        time.sleep(args.serve_interval)
        i += 1
        hb_prompt = torch.randint(
            0, cfg.vocab_size, (1, 4),
            generator=torch.Generator().manual_seed(1000 + i),
            dtype=torch.int32).to(dev)
        try:
            _emit({"event": "heartbeat", "n": i,
                   "tokens_per_sec": timed_decode(hb_prompt)})
        except Exception as e:
            _emit({"event": "heartbeat_error", "n": i, "error": str(e)})


def _serve_slots(args, cfg, params, dev, registry, boot_report,
                 result, moe_cfg=None) -> None:
    """Continuous batching behind the HTTP front door; never returns."""
    from ..models.ingress import ServingFrontend
    t_compile = time.perf_counter()
    server, page_stats = _make_serving_engine(args, cfg, params, dev,
                                              registry, moe=moe_cfg)
    warmup = getattr(server, "warmup", None)
    if warmup is not None:
        # capture the one-step window graph now, so the first request
        # does not pay for it (other windows are captured at first use)
        warmup()
    compile_s = time.perf_counter() - t_compile
    registry.observe("autoscale.cold_start.compile_seconds", compile_s)
    _start_weight_server(args)
    port = args.serve_port
    if port < 0:          # default: the reserved port, else any
        port = int(os.environ.get("PORT_SERVE", "0"))
    t_admit = time.perf_counter()
    frontend = ServingFrontend(server, port=port, max_queue=args.queue_limit,
                               decode_window=args.decode_window,
                               metrics=registry)
    frontend.start()
    # re-stamp the readiness marker now that the front door listens
    with open("serving.ready", "w") as f:
        f.write(f"ok {frontend.port}\n")
    admit_s = time.perf_counter() - t_admit
    registry.observe("autoscale.cold_start.admit_seconds", admit_s)
    cold_start_s = (boot_report["fetch_s"] + boot_report["restore_s"]
                    + compile_s + admit_s)
    registry.observe("autoscale.cold_start_seconds", cold_start_s)
    _emit({"event": "serving", "slots": args.slots, "port": frontend.port,
           "cold_start": {
               "total_s": round(cold_start_s, 4),
               "source": boot_report["source"],
               "fetch_s": boot_report["fetch_s"],
               "restore_s": boot_report["restore_s"],
               "compile_s": round(compile_s, 4),
               "admit_s": round(admit_s, 4)},
           **({"paged": page_stats} if page_stats else {}),
           **_device_report(server), **result})
    i = 0
    while True:
        time.sleep(args.serve_interval)
        i += 1
        try:
            hb = {"event": "heartbeat", "n": i, **frontend.stats(),
                  "load": frontend.load_gauges(),
                  **_device_report(server)}
            if page_stats is not None:
                hb["paged"] = server.page_stats()
            _emit(hb)
        except Exception as e:
            _emit({"event": "heartbeat_error", "n": i, "error": str(e)})


# ---------------------------------------------------------------- training


def _fused_ce(args) -> bool:
    """--fused-ce arrives as a rendered spec string ('true'/'false')."""
    return yaml_bool(args.fused_ce)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _train_tree(params, opt_state) -> dict:
    """What a train checkpoint holds, in the reference's layout."""
    from ..models import train
    return {"params": params, "opt_state": train.opt_state_tree(opt_state)}


def _restore_train(out_dir: str, params, opt_state, step: int):
    """``(params, opt_state)`` of ``step`` under ``out_dir``, restored
    into the live tree's structure, dtypes and device."""
    from ..models import train
    from ..parallel import checkpoint as ckpt
    tree = ckpt.restore_sharded(out_dir, _train_tree(params, opt_state),
                                step)
    return tree["params"], train.opt_state_from_tree(tree["opt_state"])


def _train_device_report(dev: torch.device) -> dict:
    """The flash-attention kernels' launches in this process and the peak
    device memory (CUDA only)."""
    from ..ops import flash_attention as fa
    if dev.type != "cuda":
        return {}
    return {"launches": {name: getattr(fa, name).launches for name in (
                "flash_attention_fwd", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq")},
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def run_llama_train(args) -> dict:
    """LM training of the tiny Llama on one device: the reference's
    dp-sp-tp variant, whose ``divisor_at_most`` clamps every axis to 1 on
    one device (mesh dp=sp=tp=1), with its optimizer, warm-up, resume,
    guarded loop and report. The warm-up step runs on the fresh init; a
    fresh run keeps its update (so a fresh ``--steps N`` saves counts
    N + 1), a resumed run overwrites it with the newest checkpoint under
    ``--out``.

    The reference trains under a mesh, where its ``auto`` attention is
    dense (``models/llama.py::_make_attn_fn``): ``--attn auto`` is dense
    here too, and ``--attn flash`` takes the flash-attention kernels."""
    from .._device import resolve_device
    from ..models import llama, train
    from ..parallel import checkpoint as ckpt
    from ..parallel import distributed
    from . import sentinel as sentinel_mod

    if args.pp > 1:
        raise NotPorted("pipeline_not_ported", "--pp > 1: pipeline-parallel "
                        "training is not ported yet (ROADMAP Queue 1 item 9)")
    if args.ep > 1:
        raise NotPorted("moe_not_ported", "--ep > 1: expert-parallel (MoE) "
                        "training needs the device mesh, not ported yet "
                        "(ROADMAP Queue 1 item 7)")
    if args.attn in ("ring", "ulysses"):
        raise NotPorted("attn_not_ported", f"--attn {args.attn}: sequence-"
                        "parallel attention is not ported yet (ROADMAP "
                        "Queue 1 item 9)")
    if str(os.environ.get("RESHARD_ENABLE", "0")).strip().lower() \
            not in ("", "0", "false", "no"):
        raise NotPorted("reshard_not_ported", "RESHARD_ENABLE: restart-free "
                        "resharding is not ported yet (ROADMAP Queue 1 item "
                        "10)")
    contract = distributed.initialize()
    dev = resolve_device(args.device)
    seq = args.seq
    cfg = llama.LlamaConfig.tiny(
        attn_impl="dense" if args.attn == "auto" else args.attn,
        max_seq=seq + 1, fused_ce=_fused_ce(args))
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, seq + 1),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.int32, device=dev)

    grad_accum = max(1, args.grad_accum)
    if grad_accum > 1 and toks.shape[0] % grad_accum:
        # degrade, don't crash-loop the gang, as the reference
        _emit({"event": "grad_accum_fallback",
               "requested": grad_accum, "batch": int(toks.shape[0])})
        grad_accum = 1
    opt = train.make_optimizer(lr=1e-3, warmup=5,
                               decay_steps=max(args.steps, 10))
    step = train.make_train_step(lambda p, b: llama.loss_fn(cfg, p, b), opt,
                                 grad_accum=grad_accum)
    opt_state = train.init_opt_state(opt, params)
    params, opt_state, out = step(params, opt_state, toks)     # warm-up
    float(out["loss"])
    start = 0
    resumed = False
    if args.out and (resume_step := ckpt.latest_step(args.out)) is not None:
        t_r = time.perf_counter()
        params, opt_state = _restore_train(args.out, params, opt_state,
                                           resume_step)
        start = resume_step
        resumed = True
        _emit({"event": "resumed", "step": start, "sharded": True,
               "restore_s": round(time.perf_counter() - t_r, 6)})

    sent = sentinel_mod.FaultSentinel.from_env(emit=_emit)
    sent.install()
    _sync(dev)
    t0 = time.perf_counter()
    steps_run = 0

    def run_step(i):
        nonlocal params, opt_state, out, steps_run
        params, opt_state, out = step(params, opt_state, toks)
        steps_run += 1
        if args.out and args.ckpt_every \
                and steps_run % args.ckpt_every == 0:
            ckpt.save_sharded(args.out, i + 1, _train_tree(params, opt_state))
            _emit({"event": "checkpoint", "step": i + 1})
        return out

    def save(i):
        if args.out:
            ckpt.save_sharded(args.out, i, _train_tree(params, opt_state))
            _emit({"event": "checkpoint", "step": i})

    def restore():
        nonlocal params, opt_state
        if not args.out:
            return None
        restore_step = ckpt.latest_step(args.out)
        if restore_step is None:
            return None
        # the optimizer state travels with the params: the schedule
        # resumes at the restored step
        params, opt_state = _restore_train(args.out, params, opt_state,
                                           restore_step)
        return restore_step

    try:
        stopped, end_step = sentinel_mod.guarded_loop(
            sent, start, args.steps, run_step,
            lambda result: float(result["loss"]), save, restore, emit=_emit)
    finally:
        sent.uninstall()
    _sync(dev)
    dt = time.perf_counter() - t0
    mesh_report = {"dp": 1, "sp": 1, "tp": 1}
    if stopped == "preempted":
        # flushed by guarded_loop; main() exits 143
        return {"workload": "llama-train", "attn": args.attn, "seq": seq,
                "mesh": mesh_report, "stopped": "preempted",
                "resume_step": end_step, "steps_run": steps_run,
                "process_id": contract["process_id"],
                **_train_device_report(dev)}
    if resumed and steps_run == 0:
        # already at the target step: nothing ran, and `out` is the
        # discarded warm-up; the restored state keeps its step
        loss = None
    else:
        loss = float(out["loss"])
        if args.out:
            ckpt.save_sharded(args.out, args.steps,
                              _train_tree(params, opt_state))
    return {"workload": "llama-train", "attn": args.attn, "seq": seq,
            "fused_ce": bool(cfg.fused_ce), "grad_accum": grad_accum,
            "mesh": mesh_report, "final_loss": loss,
            "steps_run": steps_run,
            "tokens_per_sec": (round(
                toks.shape[0] * seq * steps_run / dt, 1) if steps_run
                else 0.0),
            "process_id": contract["process_id"],
            **_train_device_report(dev)}


def run_distill(args) -> dict:
    """Draft distillation: train a draft against the FROZEN serving
    target's own distribution, so ``--spec-decode`` has something worth
    proposing.

    The teacher is built as ``llama --serve`` builds its target
    (:func:`_target_config`, :func:`_init_target`: same preset, seed and
    device), so the artifact fits the engine that arms it. The student
    is a copy of the teacher's first ``--draft-layers`` layers with the
    embedding, final norm and head, every weight its own (the cut is a
    view, and the step updates in place), and trains all of them through
    the fused linear-KL head (``ops.losses.fused_linear_distillation``).
    The teacher's forward runs under ``torch.no_grad``.

    Saves a resumable train checkpoint under ``--out`` and, at the end,
    the sealed draft artifact under ``--out/draft``
    (``models.speculative.save_draft``)."""
    from torch.profiler import record_function

    from .._device import resolve_device
    from ..models import train
    from ..models.speculative import distill_loss, draft_student, save_draft
    from ..parallel import checkpoint as ckpt
    from ..parallel import distributed

    contract = distributed.initialize()
    dev = resolve_device(args.device)
    cfg_t = _target_config(args)
    seq = min(args.seq, cfg_t.max_seq)
    temp = max(float(args.distill_temp), 1e-3)
    layers = max(1, min(args.draft_layers, cfg_t.n_layers - 1))
    params_t = _init_target(cfg_t, dev)
    cfg_d, params_d = draft_student(cfg_t, params_t, layers)
    toks = torch.randint(0, cfg_t.vocab_size, (max(args.batch, 1), seq),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.int32, device=dev)
    loss_fn = distill_loss(cfg_t, params_t, cfg_d, temp)
    opt = train.make_optimizer(lr=1e-3, warmup=5,
                               decay_steps=max(args.steps, 10))
    step = train.make_train_step(loss_fn, opt)
    opt_state = train.init_opt_state(opt, params_d)
    params_d, opt_state, out = step(params_d, opt_state, toks)  # warm-up
    float(out["loss"])
    start = 0
    if args.out and (resume := ckpt.latest_step(args.out)) is not None:
        params_d, opt_state = _restore_train(args.out, params_d, opt_state,
                                             resume)
        start = resume
        _emit({"event": "resumed", "step": start, "sharded": True})
    _sync(dev)
    t0 = time.perf_counter()
    trajectory = []
    for i in range(start, args.steps):
        with record_function("distill.step"):
            params_d, opt_state, out = step(params_d, opt_state, toks)
            loss = float(out["loss"])
        trajectory.append(round(loss, 6))
        if args.emit_every and (i + 1) % args.emit_every == 0:
            _emit({"event": "progress", "step": i + 1, "loss": loss})
        if args.out and args.ckpt_every \
                and (i + 1 - start) % args.ckpt_every == 0:
            ckpt.save_sharded(args.out, i + 1,
                              _train_tree(params_d, opt_state))
            _emit({"event": "checkpoint", "step": i + 1})
    _sync(dev)
    dt = time.perf_counter() - t0
    device_report = _train_device_report(dev)   # before the saves' copies
    draft_dir = ""
    if args.out:
        t_s = time.perf_counter()
        ckpt.save_sharded(args.out, args.steps,
                          _train_tree(params_d, opt_state))
        save_s = time.perf_counter() - t_s
        draft_dir = os.path.join(args.out, "draft")
        t_s = time.perf_counter()
        save_draft(draft_dir, args.steps, cfg_d, params_d, cfg_t)
        _emit({"event": "draft_saved", "path": draft_dir,
               "step": args.steps, "draft_layers": cfg_d.n_layers,
               "save_s": round(save_s, 4),
               "draft_save_s": round(time.perf_counter() - t_s, 4)})
    steps_run = len(trajectory)
    return {"workload": "distill", "preset": args.preset,
            "draft_layers": cfg_d.n_layers, "teacher_layers": cfg_t.n_layers,
            "seq": seq, "temperature": temp,
            "loss_first": trajectory[0] if trajectory else None,
            "loss_final": trajectory[-1] if trajectory else None,
            "loss_trajectory": trajectory[-16:],
            "steps_run": steps_run, "draft_dir": draft_dir,
            "tokens_per_sec": (round(
                toks.shape[0] * seq * steps_run / dt, 1) if steps_run
                else 0.0),
            "process_id": contract["process_id"], **device_report}


WORKLOADS = {"llama": run_llama, "llama-train": run_llama_train,
             "distill": run_distill}


def build_parser() -> argparse.ArgumentParser:
    """The reference parser's flags of the ported workloads (same names,
    defaults and env knobs) plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("workload", choices=sorted(WORKLOADS))
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:N or "
                        "cpu); never falls back to the CPU on its own")
    p.add_argument("--steps", type=int, default=20,
                   help="llama-train, distill: optimizer steps")
    p.add_argument("--batch", type=int, default=32,
                   help="distill: sequences a step")
    p.add_argument("--preset", default="tiny",
                   choices=["tiny", "400m", "8b"])
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache and pages")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="weight-only int8 serving, initialised and "
                        "quantized on the host (init_quantized_params)")
    p.add_argument("--max-seq", type=int, default=0,
                   help="KV-cache length override (0 = preset default; "
                        "8b serving defaults to 2048)")
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--slots", type=int, default=0,
                   help="--serve: continuous-batching slot count; 0 = "
                        "plain heartbeat decode")
    p.add_argument("--serve", action="store_true",
                   help="keep serving after warm-up")
    p.add_argument("--serve-port", type=int, default=-1,
                   help="--serve --slots: HTTP port (default: PORT_SERVE, "
                        "else an ephemeral port; the bound port is in the "
                        "serving event)")
    p.add_argument("--pages", type=int,
                   default=int(os.environ.get("SERVE_PAGES", "0")),
                   help="--serve --slots: KV pages of the paged engine's "
                        "pool; -1 = slots x max_seq / page_size, 0 = the "
                        "slot engine. An infeasible paged config falls "
                        "back to the slot engine (paged_fallback)")
    p.add_argument("--page-size", type=int,
                   default=int(os.environ.get("SERVE_PAGE_SIZE", "64")),
                   help="--pages: tokens per KV page (must divide max_seq)")
    p.add_argument("--prefill-chunk", type=int,
                   default=int(os.environ.get("SERVE_PREFILL_CHUNK",
                                              "64")),
                   help="--pages: prompt tokens prefilled per engine step")
    p.add_argument("--kv-tier-host-pages", type=int,
                   default=int(os.environ.get("KV_TIER_HOST_PAGES",
                                              "0")),
                   help="not ported (ROADMAP Queue 1 item 10): > 0 exits 2")
    p.add_argument("--kv-tier-disk-dir",
                   default=os.environ.get("KV_TIER_DISK_DIR", ""),
                   help="not ported (item 10)")
    p.add_argument("--kv-tier-disk-pages", type=int,
                   default=int(os.environ.get("KV_TIER_DISK_PAGES",
                                              "0")),
                   help="not ported (item 10): > 0 with a disk dir exits 2")
    p.add_argument("--prefix-directory", type=float,
                   default=float(os.environ.get("PREFIX_DIRECTORY",
                                                "0")),
                   help="not ported (item 10): > 0 exits 2")
    p.add_argument("--spec-decode",
                   default=os.environ.get("SPEC_DECODE", "false"),
                   help="--serve --pages: arm speculative decode on the "
                        "paged engine (draft-propose + paged verify, 1 + "
                        "accepted tokens per target pass, the greedy "
                        "stream); true/false. Any draft problem serves "
                        "solo with a coded spec_fallback event")
    p.add_argument("--draft-checkpoint",
                   default=os.environ.get("DRAFT_CHECKPOINT", ""),
                   help="--spec-decode: the save_draft artifact directory "
                        "(sharded draft weights + draft_config.json)")
    p.add_argument("--draft-k", type=int,
                   default=int(os.environ.get("DRAFT_K", "4") or 4),
                   help="--spec-decode: draft proposals verified per "
                        "target pass (>= 2)")
    p.add_argument("--draft-layers", type=int,
                   default=int(os.environ.get("DRAFT_LAYERS", "1") or 1),
                   help="distill: student decoder layers (the teacher's "
                        "first N, copied; clamped to teacher layers - 1)")
    p.add_argument("--distill-temp", type=float,
                   default=float(os.environ.get("DISTILL_TEMP", "1.0")
                                 or 1.0),
                   help="distill: softmax temperature of both "
                        "distributions in the KL loss")
    p.add_argument("--moe-experts", type=int,
                   default=int(os.environ.get("MOE_EXPERTS", "0") or 0),
                   help="llama --serve --pages: experts in the routed MLP "
                        "(0 = dense). Raw bf16 expert banks "
                        "(init_moe_params), every decode step and prefill "
                        "chunk routed through parallel/moe.py on the local "
                        "path (dist/moe.yml). Without --pages, or with "
                        "--quant/--kv-quant, serves dense (moe_fallback)")
    p.add_argument("--moe-capacity-factor", type=float,
                   default=float(os.environ.get("MOE_CAPACITY_FACTOR",
                                                "0") or 0),
                   help="llama --serve --moe-experts: expert buffer slots "
                        "= tokens/experts * factor. 0 (default) = dropless "
                        "(factor = experts): routing is independent of "
                        "token grouping, so in fp32 serving is token-exact "
                        "vs generate_stepwise_moe (bf16 roundings can flip "
                        "a near-tied route); smaller factors drop "
                        "overflowing tokens")
    p.add_argument("--moe-routing", default="top2",
                   choices=["top2", "expert_choice"],
                   help="llama --serve --moe-experts: token-choice top-2 "
                        "(GShard) or expert-choice (balanced by "
                        "construction, but ranks tokens against the whole "
                        "group, so it is non-causal; see parallel/moe.py)")
    p.add_argument("--longctx-ring", type=int,
                   default=int(os.environ.get("LONGCTX_RING", "0") or 0),
                   help="--prefill-seq-parallel's ring size (not ported)")
    p.add_argument("--prefill-seq-parallel",
                   default=os.environ.get("PREFILL_SEQ_PARALLEL",
                                          "false"),
                   help="not ported (item 9): true exits 2, unless MoE "
                        "is served (then longctx_fallback longctx_with_moe)")
    p.add_argument("--queue-limit", type=int, default=64,
                   help="--serve --slots: bounded ingress queue "
                        "(overflow answers 503 + Retry-After)")
    p.add_argument("--decode-window", type=int, default=8,
                   help="--serve --slots: tokens decoded per window "
                        "(one CUDA graph replay, one host transfer)")
    p.add_argument("--serve-interval", type=float, default=30.0,
                   help="--serve: seconds between heartbeats")
    p.add_argument("--serve-role",
                   default=os.environ.get("SERVE_ROLE", "colocated"),
                   choices=["colocated", "prefill", "decode", "router"],
                   help="--serve: tier role; only colocated is ported "
                        "(the others are item 10 and exit 2)")
    p.add_argument("--route-replicas",
                   default=os.environ.get("ROUTE_REPLICAS", ""),
                   help="router (not ported)")
    p.add_argument("--route-policy",
                   default=os.environ.get("ROUTE_POLICY", "affinity"),
                   choices=["affinity", "random"],
                   help="router (not ported)")
    p.add_argument("--route-affinity-pages", type=int,
                   default=int(os.environ.get("ROUTE_AFFINITY_PAGES",
                                              "1")),
                   help="router (not ported)")
    p.add_argument("--route-vnodes", type=int,
                   default=int(os.environ.get("ROUTE_VNODES", "64")),
                   help="router (not ported)")
    p.add_argument("--route-spill-pressure", type=float,
                   default=float(os.environ.get("ROUTE_SPILL_PRESSURE",
                                                "0.85")),
                   help="router (not ported)")
    p.add_argument("--route-spill-floor", type=int,
                   default=int(os.environ.get("ROUTE_SPILL_FLOOR", "0")),
                   help="router (not ported)")
    p.add_argument("--tenant-classes",
                   default=os.environ.get("TENANT_CLASSES", ""),
                   help="router (not ported)")
    p.add_argument("--tenant-max-tracked", type=int,
                   default=int(os.environ.get("TENANT_MAX_TRACKED",
                                              "4096")),
                   help="router (not ported)")
    p.add_argument("--serve-peer",
                   default=os.environ.get("SERVE_PEER", ""),
                   help="--serve-role decode's prefill tier (not ported)")
    p.add_argument("--attn", default="auto",
                   choices=["auto", "dense", "flash", "ring", "ulysses"],
                   help="llama-train: attention (ring and ulysses are not "
                        "ported, item 9: exit 2)")
    p.add_argument("--ring-layout", default="contiguous",
                   choices=["contiguous", "zigzag"],
                   help="llama-train --attn ring's block order (not "
                        "ported; zigzag degrades to contiguous)")
    p.add_argument("--seq", type=int, default=256,
                   help="llama-train, distill: sequence length")
    p.add_argument("--fused-ce", default=os.environ.get("FUSED_CE", "true"),
                   help="llama-train: fused linear-cross-entropy loss head "
                        "(the [B, S, V] fp32 logits never materialize); "
                        "true/false (spec boolean)")
    p.add_argument("--grad-accum", type=int,
                   default=int(os.environ.get("GRAD_ACCUM", "1") or 1),
                   help="llama-train: gradient-accumulation microbatches "
                        "per optimizer step; one the batch does not divide "
                        "falls back to 1 (grad_accum_fallback)")
    p.add_argument("--sp", type=int, default=0,
                   help="llama-train: sequence-parallel mesh size (0=auto; "
                        "1 on one device)")
    p.add_argument("--tp", type=int, default=0,
                   help="llama-train: tensor-parallel mesh size (0=auto; "
                        "1 on one device)")
    p.add_argument("--pp", type=int, default=0,
                   help="llama-train: pipeline stages (not ported, item 9: "
                        "> 1 exits 2)")
    p.add_argument("--ep", type=int, default=0,
                   help="llama-train: expert-parallel size (not ported, "
                        "item 7: > 1 exits 2)")
    p.add_argument("--emit-every", type=int, default=0,
                   help="distill: emit a {event: progress, step, loss} "
                        "line every N steps (0 = off)")
    p.add_argument("--out", default="",
                   help="the task's volume: created if absent; --serve "
                        "restores the newest sharded checkpoint in it; "
                        "llama-train and distill checkpoint into it and "
                        "resume from it")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="llama-train, distill: save a sharded checkpoint "
                        "every N steps (0 = only at the end)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace of the whole "
                        "workload here (env TPU_PROFILE_DIR also works)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    if num_slices > 1:
        print(f"error: workload {args.workload!r} does not support "
              f"multislice (MEGASCALE_NUM_SLICES={num_slices}); "
              "use the resnet dp trainer or drop tpu.slices",
              file=sys.stderr)
        return 2
    _emit({"event": "start", "workload": args.workload,
           "task": os.environ.get("TASK_NAME", "?"),
           "pod_index": os.environ.get("POD_INSTANCE_INDEX", "0"),
           "pid": os.getpid()})
    profile_dir = args.profile_dir or os.environ.get("TPU_PROFILE_DIR", "")
    try:
        if profile_dir:
            result = _profiled(args, profile_dir)
        else:
            result = WORKLOADS[args.workload](args)
    except (NotPorted, NotImplementedError) as e:
        code = getattr(e, "code", "not_ported")
        _emit({"event": "error", "code": code, "error": str(e)})
        print(f"error: {code}: {e}", file=sys.stderr)
        return 2
    _emit({"event": "done", **result})
    if result.get("stopped") == "preempted":
        # the conventional SIGTERM exit: the checkpoint is flushed, and
        # the scheduler's relaunch resumes from it
        return 143
    return 0


def _profiled(args, profile_dir: str) -> dict:
    """The workload under ``torch.profiler`` (CPU, and CUDA activities
    when it runs on the card); the Chrome trace lands in
    ``profile_dir/worker-<pid>.trace.json`` when the workload returns."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    _emit({"event": "profiling", "dir": profile_dir})
    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = WORKLOADS[args.workload](args)
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"worker-{os.getpid()}.trace.json"))
    return result


if __name__ == "__main__":
    raise SystemExit(main())
