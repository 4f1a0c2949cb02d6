"""Task-side worker of the port: what a scheduled pod instance runs (port
of ``frameworks/jax/worker.py``, its ``llama`` workload).

    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset tiny
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 [--pages 64] [--quant int8] [--kv-quant] \\
        [--spec-decode true --draft-checkpoint DIR --draft-k 4] [--out VOL]

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

``--spec-decode true --draft-checkpoint DIR`` arms the paged engine with
a sealed draft artifact (``models.speculative.save_draft``): a
``spec_armed`` event, or a coded ``spec_fallback`` (the reference's
codes) and solo serving. A serving worker whose ``--out`` holds a
sharded checkpoint (``parallel.checkpoint``) restores its weights from
it (``weights_loaded`` with ``source`` ``disk``), or emits
``weight_restore_fallback`` and serves the init.

What is not ported yet refuses loudly, never serves without it: a
knob of a module still to port exits 2 with a coded ``error`` event
naming its ROADMAP Queue 1 item (peer weights: item 6; gangs: item 7;
MoE and ring prefill: item 9; disaggregation, the router, KV tiers and
the prefix directory: item 10; profiling and the other workloads: item
4). The weight server is an accelerant in the reference, so asking for
it only emits ``weight_server_error``.
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
    if args.moe_experts > 0:
        raise NotPorted("moe_not_ported", "--moe-experts: MoE serving is "
                        "not ported yet (ROADMAP Queue 1 item 9)")
    if yaml_bool(args.prefill_seq_parallel):
        raise NotPorted("longctx_not_ported", "--prefill-seq-parallel: "
                        "ring prefill is not ported yet (ROADMAP Queue 1 "
                        "item 9)")
    disk = args.kv_tier_disk_pages if args.kv_tier_disk_dir else 0
    if args.kv_tier_host_pages > 0 or disk > 0:
        raise NotPorted("kv_tiers_not_ported", "--kv-tier-*: host and "
                        "disk KV tiers are not ported yet (ROADMAP Queue 1 "
                        "item 10)")
    if args.prefix_directory > 0:
        raise NotPorted("prefix_directory_not_ported", "--prefix-directory:"
                        " the fleet prefix directory is not ported yet "
                        "(ROADMAP Queue 1 item 10)")


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


def _make_serving_engine(args, cfg, params, device, registry=None):
    """``PagedServer`` with ``--pages`` (sharing the process-wide compile
    cache), ``SlotServer`` otherwise. A paged config the model cannot
    satisfy falls back to the slot engine with a ``paged_fallback``
    event, as in the reference. ``--spec-decode`` arms the paged engine
    (:func:`_arm_spec_decode`); without one it emits ``spec_fallback``
    with ``spec_needs_paged`` and serves solo."""
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
                compile_cache=aot.from_env(), device=device)
            if spec_wanted:
                _arm_spec_decode(args, cfg, engine, registry)
            return engine, engine.page_stats()
        except ValueError as e:
            _emit({"event": "paged_fallback", "error": str(e),
                   "pages": args.pages, "page_size": args.page_size,
                   "prefill_chunk": args.prefill_chunk})
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


def run_llama(args) -> dict:
    """Llama inference on one device: the solo decode rate, then with
    ``--serve`` a serving loop that never returns while healthy."""
    from .._device import resolve_device
    from ..models import llama
    from ..parallel import distributed

    _refuse_unported(args)
    contract = distributed.initialize()
    dev = resolve_device(args.device)
    kv_quant = args.kv_quant
    if args.preset == "8b":
        cfg = llama.LlamaConfig.llama3_8b(max_seq=args.max_seq or 2048,
                                          remat=False, kv_quant=kv_quant)
    elif args.preset == "400m":
        cfg = llama.LlamaConfig.llama_400m(max_seq=args.max_seq or 2048,
                                           kv_quant=kv_quant)
    elif args.max_seq:
        cfg = llama.LlamaConfig.tiny(max_seq=args.max_seq,
                                     kv_quant=kv_quant)
    else:
        cfg = llama.LlamaConfig.tiny(kv_quant=kv_quant)
    gen_len = args.gen_len
    # chunked decode for everything but tiny, as in the reference
    chunked = args.preset != "tiny" or args.quant != "none"
    # chunked rounds the continuation up to whole chunks before trimming;
    # divide by the EXECUTED token count or tps reads low off-alignment
    exec_len = (1 + -(-(gen_len - 1) // 16) * 16) if chunked else gen_len

    def timed_decode(prompt):
        t0 = time.perf_counter()
        if chunked:
            toks = llama.generate_chunked(cfg, params, prompt, gen_len,
                                          chunk=16)
        else:
            toks = llama.generate(cfg, params, prompt, gen_len)
        toks.cpu()
        return round(exec_len / max(time.perf_counter() - t0, 1e-9), 2)

    def init():
        if args.quant == "int8":
            # init + quantize on the host CPU: no bf16 weight on the device
            return llama.init_quantized_params(
                cfg, torch.Generator().manual_seed(0), device=dev)
        return llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    registry = None
    boot_report = {"source": "init", "fetch_s": 0.0, "restore_s": 0.0}
    if args.serve:
        from ..metrics import MetricsRegistry
        registry = MetricsRegistry()
    if args.serve and args.quant == "none":
        params, boot_report = _boot_serving_weights(
            args, llama.param_template(cfg, dev), init, registry)
    else:
        # int8 replicas keep their freshly quantized init, as in the
        # reference: quantized trees are outside the restore template
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
        _serve_slots(args, cfg, params, dev, registry, boot_report, result)
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
                 result) -> None:
    """Continuous batching behind the HTTP front door; never returns."""
    from ..models.ingress import ServingFrontend
    t_compile = time.perf_counter()
    server, page_stats = _make_serving_engine(args, cfg, params, dev,
                                              registry)
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


WORKLOADS = {"llama": run_llama}


def build_parser() -> argparse.ArgumentParser:
    """The reference parser's ``llama`` flags (same names, defaults and
    env knobs) plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("workload", choices=sorted(WORKLOADS))
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:N or "
                        "cpu); never falls back to the CPU on its own")
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
    p.add_argument("--moe-experts", type=int,
                   default=int(os.environ.get("MOE_EXPERTS", "0") or 0),
                   help="not ported (item 9): > 0 exits 2")
    p.add_argument("--moe-capacity-factor", type=float,
                   default=float(os.environ.get("MOE_CAPACITY_FACTOR",
                                                "0") or 0),
                   help="--moe-experts' capacity (not ported)")
    p.add_argument("--moe-routing", default="top2",
                   choices=["top2", "expert_choice"],
                   help="--moe-experts' routing (not ported)")
    p.add_argument("--longctx-ring", type=int,
                   default=int(os.environ.get("LONGCTX_RING", "0") or 0),
                   help="--prefill-seq-parallel's ring size (not ported)")
    p.add_argument("--prefill-seq-parallel",
                   default=os.environ.get("PREFILL_SEQ_PARALLEL",
                                          "false"),
                   help="not ported (item 9): true exits 2")
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
    p.add_argument("--out", default="",
                   help="the task's volume: created if absent; --serve "
                        "restores the newest sharded checkpoint in it")
    p.add_argument("--profile-dir", default="",
                   help="not ported (item 4): set, or TPU_PROFILE_DIR set, "
                        "exits 2")
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
    try:
        if args.profile_dir or os.environ.get("TPU_PROFILE_DIR", ""):
            raise NotPorted("profile_not_ported", "--profile-dir / "
                            "TPU_PROFILE_DIR: profiling the worker is not "
                            "ported yet (ROADMAP Queue 1 item 4)")
        result = WORKLOADS[args.workload](args)
    except (NotPorted, NotImplementedError) as e:
        code = getattr(e, "code", "not_ported")
        _emit({"event": "error", "code": code, "error": str(e)})
        print(f"error: {code}: {e}", file=sys.stderr)
        return 2
    _emit({"event": "done", **result})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
