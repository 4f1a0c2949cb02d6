"""Task-side worker of the port: what a scheduled pod instance runs (port
of ``frameworks/jax/worker.py``: its ``mnist``, ``resnet``, ``llama``,
``llama-train`` and ``distill`` workloads).

    python -m dcos_commons_tpu_torch.frameworks.worker mnist --steps 200 \
        --out VOL
    python -m dcos_commons_tpu_torch.frameworks.worker resnet --steps 200 \
        --batch 256 [--depth 50] [--lr 0.1] [--emit-every N] --out VOL
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset tiny
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 [--pages 64] [--quant int8] [--kv-quant] \\
        [--spec-decode true --draft-checkpoint DIR --draft-k 4] [--out VOL]
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 --pages -1 --moe-experts 8 --moe-capacity-factor 0
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \
        --serve --slots 8 --pages 64 --kv-tier-host-pages 32 \
        --kv-tier-disk-dir DIR --kv-tier-disk-pages 96 [--prefix-directory S]
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 --pages 64 --serve-role prefill --serve-port P
    python -m dcos_commons_tpu_torch.frameworks.worker llama --preset 8b \\
        --serve --slots 8 --pages 64 --serve-role decode \\
        --serve-peer http://HOST:P
    python -m dcos_commons_tpu_torch.frameworks.worker llama --serve \\
        --serve-role router --route-replicas http://HOST:P,http://HOST:Q \\
        --page-size 64 [--route-policy affinity|random] \\
        [--tenant-classes gold:10:50:100:250,free:1:2:4]
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

``--prefill-seq-parallel true`` (with ``--pages``, ``dist/longctx.yml``'s
``server`` pod) on a gang of N serves over ``MeshSpec(sp=N)`` with ring
prefill armed (``PagedServer(longctx_ring=N)``): every rank holds the
whole weights and pool, and a prompt of at least twice
``--prefill-chunk`` tokens prefills in one sequence-parallel tick. On
one device, with ``--kv-quant``, without ``--pages``, with a
``--longctx-ring`` other than N or an N that does not divide
``--max-seq``, ``longctx_fallback`` gives the reference's code and the
replica prefills in chunks.

``--kv-tier-host-pages H``, ``--kv-tier-disk-dir D --kv-tier-disk-pages
M`` (with ``--pages``) give the paged engine a host/disk KV tier store
(``models.paging.PageTierStore``): evicted radix pages demote there and
promote back on a hit. A disk directory that cannot be used emits
``kv_tier_fallback`` and the replica serves single-tier.
``--prefix-directory S`` (> 0) keeps a ``PrefixDirectory`` with a
staleness window of S seconds and adopts prefixes from siblings'
``/v1/prefix`` (``models.disagg.fetch_prefix``); the replica publishes
its chains under its front door's address.

``--serve-role prefill`` (with ``--slots`` and ``--pages``) serves the
prefill tier of a disaggregated pair (``models.disagg.PrefillWorker``:
``POST /v1/prefill`` answers packed KV spans); ``--serve-role decode
--serve-peer URL[,URL...]`` serves the client front door and adopts the
spans the prefill tier ships (``DisaggCoordinator``). Without
``--slots``, without ``--pages``, with an infeasible paged engine or a
decode tier without a peer, ``disagg_fallback`` says why and the replica
serves co-located, as in the reference.

``--serve-role router`` runs the fleet front door (``models.router``,
``dist/fleet.yml``): prefix-affinity routing across ``--route-replicas``
with per-tenant admission from ``--tenant-classes``. It carries no model:
it builds no weights, touches no device (its heartbeat says
``cuda_initialized: false``), and ``--page-size`` must match the decode
tier's. A bad ``--tenant-classes`` emits ``router_config_error`` and the
router serves with admission open.

``--spec-decode true --draft-checkpoint DIR`` arms the paged engine with
a sealed draft artifact (``models.speculative.save_draft``): a
``spec_armed`` event, or a coded ``spec_fallback`` (the reference's
codes) and solo serving.

Serving weights come, in the reference's order, from a hot sibling's
weight server (``WEIGHT_FETCH_PEERS=URL[,URL...]``, within
``WEIGHT_FETCH_TIMEOUT_S``; ``models.weights``: mirrored into ``--out``
when it is set, then restored; ``source`` ``peer``), from the newest
sharded checkpoint under ``--out`` (``source`` ``disk``), or from the
init; a failed fetch emits ``weight_fetch_fallback``, a failed restore
``weight_restore_fallback``, and the boot goes on to the next source.
``WEIGHT_SERVE_PORT`` (or ``PORT_WEIGHTS``) with ``--out`` serves this
replica's committed steps to its siblings (``weight_server``; step 0 is
seeded from the serving weights when none is committed), or emits
``weight_server_error`` and serving goes on.

``mnist`` trains the MNIST MLP on synthetic batches and ``resnet`` a
ResNet (``--depth``, default 50) on one fixed synthetic 224x224 batch a
process, checkpointing into ``--out`` under the reference's keys and
resuming from it (``resumed``); ``resnet`` keeps the warm-up step's
update, so the two packages resume each other's checkpoints.

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

Under the rank contract with ``JAX_NUM_PROCESSES`` N > 1, ``llama``
serves as a tensor-parallel gang (``dist/llama.yml``): every process
forms the gloo process group, builds ``MeshSpec(tp=N)`` (one device a
process, ``cuda:(rank % device_count)``; NCCL for the device collectives
when no two ranks share a card), draws the weights from the seed and
keeps its Megatron shard (or restores its own shards from ``--out``),
reports ``"tp": N``, and with ``--slots`` serves through the rank-0 gang
loop (``models.serving_gang``): rank 0 owns the front door
(``serving.ready``, ``/v1/stats`` with the gang counters), every rank
runs the lock-step loop and its heartbeats. ``--serve-role
prefill|decode`` on a gang emits ``disagg_fallback`` and serves
co-located. ``--moe-experts E`` on a gang serves over ``MeshSpec(ep=N)``
instead (``--prefill-seq-parallel`` over ``MeshSpec(sp=N)``, above), as
the reference's ``_serving_arithmetic`` does when N divides
E: every rank holds the whole weights but only its E/N experts
(``llama.init_moe_params(..., mesh=)``), and the paged engine's MoE
layer dispatches over ep (``parallel.moe.moe_apply``). A gang that does
not divide the experts (``moe_ep_indivisible``: the reference's path for
it cannot build its mesh) and ``WEIGHT_FETCH_PEERS`` /
``WEIGHT_SERVE_PORT`` (``peer_weights_not_ported``, item 10e) on a gang
are refused before any process group forms.

The training workloads train on a gang as the reference's do
(``dist/resnet.yml``, ``multislice.yml``): ``resnet`` over
``MeshSpec(dp=N // slices, dcn=slices)`` (``MEGASCALE_NUM_SLICES``; a gang
the slices do not divide raises as the reference's mesh does), each
process its own share of the global batch of ``--batch x N`` with
batch-norm statistics over all of it, every process resuming at the
newest step every process holds and saving the whole state to its own
``step-N-p{rank}``; ``distill`` over ``MeshSpec(dp=N)``; ``llama-train``
over the reference's clamped axes as ``MeshSpec(dp, sp, tp)``
(``dist/longctx.yml``'s ``worker`` pods: ring or Ulysses attention over
``sp``, its default 2 on an even gang), each rank holding its Megatron
shards and its sequence shard; with ``--pp N`` (checked first) or ``--ep
N`` the reference's pipelined and MoE variants over ``MeshSpec(dp=n //
pp, pp=pp)`` and ``MeshSpec(dp=n // ep, ep=ep)``, every rank computing
the whole batch and holding its stage or its experts; ``mnist`` trains
alone in each process, as in the reference.
The ranks' collectives (``parallel.mesh``) run over gloo when ranks
share a card.

What is not ported yet refuses loudly, never runs without it: a knob of
a module still to port exits 2 with a coded ``error`` event naming its
ROADMAP Queue 1 item (live resharding: item 10).
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


def _gang_size() -> int:
    """The processes the scheduler's rank contract asks for (no process
    group is formed, nothing is contacted)."""
    from ..parallel import distributed
    contract = distributed.env_contract()
    return contract["num_processes"] if contract else 1


def _divisor_at_most(limit: int, total: int) -> int:
    """The largest divisor of ``total`` not above ``limit``: axis sizes
    that do not factorize the gang are clamped, as in the reference."""
    for cand in range(max(min(limit, total), 1), 0, -1):
        if total % cand == 0:
            return cand
    return 1


def _train_mesh(device: str, dp: int, tp: int = 1, dcn: int = 1,
                sp: int = 1, ep: int = 1, pp: int = 1):
    """The process group from the rank contract and this rank's
    ``MeshSpec(dp=dp, pp=pp, sp=sp, tp=tp, ep=ep, dcn=dcn)`` mesh on
    ``device``: ``(contract, mesh)``. A gang the mesh does not fit raises
    (ValueError), as the reference's mesh does; a gang never trains
    alone."""
    from ..parallel import distributed
    from ..parallel.mesh import MeshSpec
    contract = distributed.initialize()
    return contract, MeshSpec(dp=dp, pp=pp, sp=sp, tp=tp, ep=ep,
                              dcn=dcn).build(device)


def _mesh_report(mesh) -> dict:
    """On a gang: the dp axis (and sp and tp, when larger than 1), and
    the collectives' count and host seconds (the device wait before each
    staged copy excluded); nothing for one process, whose result keys
    stay the reference's."""
    if mesh.size == 1:
        return {}
    return {"dp": mesh.shape["dp"],
            **{a: mesh.shape[a] for a in ("pp", "sp", "tp", "ep")
               if mesh.shape[a] > 1},
            "collectives": mesh.collectives,
            "collective_s": round(mesh.collective_s, 6),
            "backend": mesh.backend}


def _serving_arithmetic(args, cfg, n: int):
    """The reference's serving arithmetic for a replica of ``n`` devices
    (a gang of ``n`` processes, one device each): ``(moe_cfg, ring,
    mesh_spec)``, or ``(None, 0, None)`` for the dense (tp on a gang)
    stack, with the reference's coded events. MoE serves through the
    paged engine only (``moe_fallback`` ``moe_needs_paged``) and on raw
    bf16 expert banks (``moe_quant``), else the replica serves dense; its
    capacity is ``--moe-capacity-factor`` (1.0 when unset), dropless
    when it is <= 0; its mesh is ``MeshSpec(ep=n)`` when n divides the
    experts, else ``ep=1`` with ``moe_note`` ``moe_local_dispatch`` (on
    a gang the port refuses that, ``moe_ep_indivisible``).
    ``--prefill-seq-parallel`` arms ring prefill over ``MeshSpec(sp=n)``,
    or emits ``longctx_fallback`` and prefills in chunks: with MoE
    (``longctx_with_moe``), without ``--pages`` (``longctx_needs_paged``),
    with ``--kv-quant`` (``longctx_quant``), on one device or with a
    ``--longctx-ring`` other than n (``longctx_ring_devices``), or when n
    does not divide ``max_seq`` (``longctx_ring_max_seq``). The decision
    is pure config, so every rank of a gang makes the same one."""
    from ..parallel.mesh import MeshSpec
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
    ring = 0
    if yaml_bool(args.prefill_seq_parallel):
        want = args.longctx_ring or n
        if moe_cfg is not None:
            _emit({"event": "longctx_fallback", "code": "longctx_with_moe",
                   "error": "one replica mesh carries ep OR sp; MoE decode "
                            "wins, prefill stays chunked"})
        elif not args.pages:
            _emit({"event": "longctx_fallback",
                   "code": "longctx_needs_paged",
                   "error": "ring prefill is a paged-engine path: set "
                            "--pages/SERVE_PAGES"})
        elif args.kv_quant:
            _emit({"event": "longctx_fallback", "code": "longctx_quant",
                   "error": "ring prefill installs bf16 K/V spans; drop "
                            "--kv-quant"})
        elif n < 2 or want != n:
            _emit({"event": "longctx_fallback",
                   "code": "longctx_ring_devices",
                   "error": f"ring size {want} != device count {n}; the "
                            "sp axis runs over the replica's whole gang"})
        elif cfg.max_seq % n:
            _emit({"event": "longctx_fallback",
                   "code": "longctx_ring_max_seq",
                   "error": f"ring {n} must divide max_seq {cfg.max_seq} "
                            "so padded prompts stay in-table"})
        else:
            ring = n
    if moe_cfg is not None:
        ep = n if moe_cfg.num_experts % n == 0 else 1
        if ep == 1 and n > 1:
            _emit({"event": "moe_note", "code": "moe_local_dispatch",
                   "experts": moe_cfg.num_experts, "devices": n,
                   "note": "device count does not divide the expert "
                           "count; experts stay replicated and dispatch "
                           "runs the bitwise-equal local path (no "
                           "all-to-all)"})
        return moe_cfg, 0, MeshSpec(ep=ep)
    if ring:
        return None, ring, MeshSpec(sp=ring)
    return None, 0, None


def _boot_serving_weights(args, template, init, registry=None, mesh=None,
                          specs=None):
    """Serving weights from, in the reference's order: a hot sibling's
    weight server (``WEIGHT_FETCH_PEERS``, within
    ``WEIGHT_FETCH_TIMEOUT_S``); the newest sharded checkpoint under
    ``--out``; or ``init()``. A restore reads into ``template()``, a tree
    of uninitialised tensors built only for a restore, so the device
    never holds the weights twice.

    With ``--out`` a peer boot first mirrors the peer's newest step into
    the local directory (dot-tmp + rename), then restores from it, so the
    new replica serves its own siblings and restarts from disk; without
    it the peer's shards stream straight into the template. A failed
    fetch emits ``weight_fetch_fallback`` and a failed restore
    ``weight_restore_fallback``, and the boot goes on to the next source.
    The fetch and restore seconds land in the registry
    (``autoscale.cold_start.{fetch,restore}_seconds``) and the returned
    report, as in the reference. On a gang (``mesh``, with the tree's
    ``specs``) each rank restores its own shards from its own step
    directory, at the newest step every rank holds, and the ranks agree
    on the outcome: if one cannot restore, every rank takes ``init()``;
    a gang never fetches from a peer (refused before boot)."""
    from ..parallel import checkpoint as ckpt

    report = {"source": "init", "fetch_s": 0.0, "restore_s": 0.0}

    def obs(phase, dt):
        report[f"{phase}_s"] = round(dt, 4)
        if registry is not None:
            registry.observe(f"autoscale.cold_start.{phase}_seconds", dt)

    peers = [p.strip() for p in
             os.environ.get("WEIGHT_FETCH_PEERS", "").split(",")
             if p.strip()]
    timeout_s = float(os.environ.get("WEIGHT_FETCH_TIMEOUT_S") or 120.0)
    if peers:
        from ..models import weights as weights_mod
        try:
            if args.out:
                t0 = time.perf_counter()
                step = weights_mod.mirror_from_peers(
                    peers, args.out, timeout_s=timeout_s)
                obs("fetch", time.perf_counter() - t0)
                t0 = time.perf_counter()
                params = ckpt.restore_sharded(args.out, template(), step)
                obs("restore", time.perf_counter() - t0)
            else:
                t0 = time.perf_counter()
                params = weights_mod.restore_from_peers(
                    peers, template(), timeout_s=timeout_s,
                    metrics=registry)
                obs("restore", time.perf_counter() - t0)
            report["source"] = "peer"
            return params, report
        except (weights_mod.WeightFetchError, ckpt.CheckpointCorrupt,
                OSError) as e:
            _emit({"event": "weight_fetch_fallback", "error": str(e),
                   "peers": peers})
    step = ckpt.latest_step(args.out) if args.out else None
    if step is not None:
        params, error = None, None
        t0 = time.perf_counter()
        try:
            params = ckpt.restore_sharded(args.out, template(), step,
                                          mesh=mesh, specs=specs)
        except (FileNotFoundError, ckpt.CheckpointCorrupt) as e:
            error = str(e)
        dt = time.perf_counter() - t0
        failed = _failed_ranks(error is not None, mesh)
        if not failed:
            obs("restore", dt)
            report["source"] = "disk"
            report["step"] = step
            return params, report
        # a gang serves one set of weights: if any rank could not
        # restore, every rank takes the init
        del params
        _emit({"event": "weight_restore_fallback",
               "error": error or f"gang ranks {failed} could not restore "
                                 f"step {step}",
               "step": step})
    return init(), report


def _failed_ranks(failed: bool, mesh) -> list:
    """The ranks of the gang whose flag is set, agreed over its gloo
    group; ``[0]`` or ``[]`` for one process."""
    if mesh is None or mesh.size == 1:
        return [0] if failed else []
    import numpy as np
    from ..parallel.mesh import host_all_gather
    rows = host_all_gather(np.array([int(failed)], np.int64))
    return [r for r, row in enumerate(rows) if row[0]]


def _start_weight_server(args, params, registry=None):
    """Expose this replica's checkpoint steps to booting siblings
    (``WEIGHT_SERVE_PORT``/``PORT_WEIGHTS`` with ``--out``): a replica
    whose ``--out`` holds no committed step seeds step 0 with its
    serving weights first, so a tier's first replica is already a valid
    peer for the second. Returns the started ``WeightServer``, or None.
    A port or directory it cannot use emits ``weight_server_error`` and
    serving goes on: weight serving is an accelerant, never a liveness
    dependency."""
    port = (os.environ.get("WEIGHT_SERVE_PORT")
            or os.environ.get("PORT_WEIGHTS"))
    if not args.out or port is None:
        return None
    from ..models import weights as weights_mod
    from ..parallel import checkpoint as ckpt
    try:
        seed_save_s = 0.0
        if ckpt.latest_step(args.out) is None:
            t0 = time.perf_counter()
            ckpt.save_sharded(args.out, 0, params)
            seed_save_s = time.perf_counter() - t0
        server = weights_mod.WeightServer(args.out, port=int(port),
                                          metrics=registry).start()
        _emit({"event": "weight_server", "port": server.port,
               "steps": server.steps(),
               "seed_save_s": round(seed_save_s, 4)})
        return server
    except (OSError, ValueError) as e:
        _emit({"event": "weight_server_error", "error": str(e)})
        return None


def _make_serving_engine(args, cfg, params, device, registry=None,
                         moe=None, mesh=None, longctx_ring=0):
    """``PagedServer`` with ``--pages`` (sharing the process-wide compile
    cache; ``moe`` and ``longctx_ring`` from :func:`_serving_arithmetic`),
    ``SlotServer``
    otherwise. A paged config the model cannot satisfy falls back to the
    slot engine with a ``paged_fallback`` event, as in the reference;
    an MoE model, which the slot engine cannot serve, raises after the
    event instead of serving a replica that fails its first request.
    ``--spec-decode`` arms the paged engine (:func:`_arm_spec_decode`);
    without one it emits ``spec_fallback`` with ``spec_needs_paged`` and
    serves solo. ``mesh`` builds a gang member's engine."""
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
                compile_cache=aot.from_env(), moe=moe,
                longctx_ring=longctx_ring, device=device, mesh=mesh,
                **_make_kv_tiers(args))
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
    return SlotServer(cfg, params, slots=args.slots, device=device,
                      mesh=mesh), None


def _make_kv_tiers(args) -> dict:
    """``PagedServer`` tier and directory kwargs from the ``--kv-tier-*``
    and ``--prefix-directory`` knobs. An unusable disk directory drops
    the tier store with a ``kv_tier_fallback`` event and the replica
    serves single-tier: the tiers are an economy, never a dependency.
    The directory also wires ``disagg.fetch_prefix`` as the peer fetch."""
    from ..models.disagg import fetch_prefix
    from ..models.paging import PageTierStore, PrefixDirectory
    kw: dict = {}
    host = max(0, args.kv_tier_host_pages)
    disk_dir = args.kv_tier_disk_dir or None
    disk = max(0, args.kv_tier_disk_pages) if disk_dir else 0
    if host or disk:
        try:
            kw["tiers"] = PageTierStore(host_pages=host, disk_dir=disk_dir,
                                        disk_pages=disk)
        except (OSError, ValueError) as e:
            _emit({"event": "kv_tier_fallback", "error": str(e),
                   "host_pages": host, "disk_dir": disk_dir,
                   "disk_pages": disk})
    if args.prefix_directory > 0:
        kw["directory"] = PrefixDirectory(max_age_s=args.prefix_directory)
        kw["peer_fetch"] = fetch_prefix
    return kw


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


def _init_target(cfg, dev: torch.device, quant: str = "none", mesh=None):
    """The serving target's weights, from seed 0: a draft distilled from
    them fits the target ``llama --serve`` builds on the same device.
    Under a ``mesh`` this rank's shard of the same weights: every rank
    draws the whole tree from the same seed and keeps its slice, as the
    reference's ranks do."""
    from ..models import llama
    if quant == "int8":
        # init + quantize on the host CPU: no bf16 weight on the device
        return llama.init_quantized_params(
            cfg, torch.Generator().manual_seed(0), device=dev, mesh=mesh)
    return llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        mesh=mesh)


def run_llama(args) -> dict:
    """Llama inference: the solo decode rate, then with ``--serve`` a
    serving loop that never returns while healthy. One process drives one
    device; under a rank contract of N > 1 processes the weights shard
    over a ``tp=N`` process mesh (``llama.shard_params``) and ``--slots``
    serves through the rank-0 gang loop (:func:`_serve_gang`)."""
    if args.serve and args.serve_role == "router":
        # the router tier is pure control plane: no model, no device; the
        # front door comes up before anything can fail
        return _serve_router(args)
    from .._device import resolve_device
    from ..models import llama
    from ..parallel import distributed
    from ..parallel.mesh import MeshSpec

    n = _gang_size()
    cfg = _target_config(args)
    moe_cfg, ring, arith_spec = (_serving_arithmetic(args, cfg, n)
                                 if args.serve else (None, 0, None))
    if n > 1:
        # refused before the process group forms
        if moe_cfg is not None and moe_cfg.num_experts % n:
            raise NotPorted(
                "moe_ep_indivisible",
                f"--moe-experts {moe_cfg.num_experts} on a gang of {n}: "
                f"expert parallelism shards the experts over ep={n}, which "
                "must divide them (the reference's moe_note path builds "
                "MeshSpec(ep=1) on the gang and fails: ROADMAP Queue 3; "
                "item 9)")
        if os.environ.get("WEIGHT_FETCH_PEERS", "").strip() or (
                os.environ.get("WEIGHT_SERVE_PORT")
                or os.environ.get("PORT_WEIGHTS")) is not None:
            raise NotPorted("peer_weights_not_ported", f"a gang of {n}: "
                            "peer weight fetch and serve of sharded "
                            "weights (GANGSTATE) are not ported yet "
                            "(ROADMAP Queue 1 item 10e)")
    contract = distributed.initialize()
    # one replica mesh carries one inner axis, as in the reference: ep
    # for MoE, sp for ring prefill, tp otherwise
    gang = None
    if contract["num_processes"] > 1:
        gang = (arith_spec or MeshSpec(tp=contract["num_processes"])
                ).build(args.device)
    dev = gang.device if gang is not None else resolve_device(args.device)
    kv_quant = args.kv_quant
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
                                               moe_cfg, mesh=gang)
        elif chunked:
            toks = llama.generate_chunked(cfg, params, prompt, gen_len,
                                          chunk=16, mesh=gang)
        else:
            toks = llama.generate(cfg, params, prompt, gen_len, mesh=gang)
        toks.cpu()
        return round(exec_len / max(time.perf_counter() - t0, 1e-9), 2)

    def init():
        if moe_cfg is not None:
            # raw bf16 expert banks, drawn slab by slab on the device
            return llama.init_moe_params(
                cfg, moe_cfg.num_experts,
                torch.Generator(device=dev).manual_seed(0), device=dev,
                mesh=gang)
        return _init_target(cfg, dev, args.quant, gang)

    registry = None
    boot_report = {"source": "init", "fetch_s": 0.0, "restore_s": 0.0}
    if args.serve:
        from ..metrics import MetricsRegistry
        registry = MetricsRegistry()
    if args.serve and args.quant == "none" and moe_cfg is None:
        params, boot_report = _boot_serving_weights(
            args, lambda: llama.param_template(cfg, dev, mesh=gang), init,
            registry, mesh=gang, specs=llama.param_specs(cfg))
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
    # tp counts processes: a rank drives one device, and claims no other
    result = {"workload": "llama", "preset": args.preset,
              "quant": args.quant, "kv_quant": kv_quant,
              "weight_gb": round(_nbytes(params) / 1e9, 2),
              "tokens_per_sec": tokens_per_sec,
              "tp": gang.size if gang is not None else 1,
              "process_id": contract["process_id"]}
    if gang is not None:
        result["mesh"] = {"backend": gang.backend, "device": str(dev)}
    if not args.serve:
        return result
    if args.serve_role != "colocated":
        # a disaggregated tier (dist/disagg.yml) never returns while
        # healthy; a config it cannot run emits disagg_fallback and the
        # replica serves co-located below
        if gang is not None:
            _emit({"event": "disagg_fallback", "role": args.serve_role,
                   "reason": "disagg tiers need --slots on a "
                             "single-process replica; serving "
                             "co-located"})
        elif args.slots > 0:
            _serve_disagg(args, cfg, params, dev, registry, boot_report,
                          result, moe_cfg)
        else:
            _emit({"event": "disagg_fallback", "role": args.serve_role,
                   "reason": "disagg tiers need --slots on a "
                             "single-process replica; serving "
                             "co-located"})
    if args.slots > 0 and gang is not None:
        _serve_gang(args, contract, cfg, params, gang, registry, result,
                    moe_cfg, ring)
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


def _serve_port(args) -> int:
    """``--serve-port``; by default the reserved ``PORT_SERVE``, else
    any."""
    if args.serve_port >= 0:
        return args.serve_port
    return int(os.environ.get("PORT_SERVE", "0"))


def _ready(port: int, registry, boot_report, compile_s: float,
           t_admit: float) -> dict:
    """Stamp ``serving.ready`` with the bound port and return the
    ``cold_start`` report (its seconds also land in the registry)."""
    registry.observe("autoscale.cold_start.compile_seconds", compile_s)
    with open("serving.ready", "w") as f:
        f.write(f"ok {port}\n")
    admit_s = time.perf_counter() - t_admit
    registry.observe("autoscale.cold_start.admit_seconds", admit_s)
    cold_start_s = (boot_report["fetch_s"] + boot_report["restore_s"]
                    + compile_s + admit_s)
    registry.observe("autoscale.cold_start_seconds", cold_start_s)
    return {"total_s": round(cold_start_s, 4),
            "source": boot_report["source"],
            "fetch_s": boot_report["fetch_s"],
            "restore_s": boot_report["restore_s"],
            "compile_s": round(compile_s, 4),
            "admit_s": round(admit_s, 4)}


def _serve_slots(args, cfg, params, dev, registry, boot_report,
                 result, moe_cfg=None) -> None:
    """Continuous batching behind the HTTP front door, with the weight
    server (:func:`_start_weight_server`) beside it, stopped if serving
    ends; never returns while healthy."""
    t_compile = time.perf_counter()
    server, page_stats = _make_serving_engine(args, cfg, params, dev,
                                              registry, moe=moe_cfg)
    warmup = getattr(server, "warmup", None)
    if warmup is not None:
        # capture the one-step window graph now, so the first request
        # does not pay for it (other windows are captured at first use)
        warmup()
    compile_s = time.perf_counter() - t_compile
    weight_server = _start_weight_server(args, params, registry)
    try:
        _serve_front_door(args, server, page_stats, registry, boot_report,
                          result, compile_s)
    finally:
        if weight_server is not None:
            weight_server.stop()


def _serve_front_door(args, server, page_stats, registry, boot_report,
                      result, compile_s) -> None:
    """The co-located front door over ``server`` and its heartbeats;
    never returns while healthy."""
    from ..models.ingress import ServingFrontend
    t_admit = time.perf_counter()
    frontend = ServingFrontend(server, port=_serve_port(args),
                               max_queue=args.queue_limit,
                               decode_window=args.decode_window,
                               metrics=registry)
    frontend.start()
    if getattr(server, "directory", None) is not None:
        # the directory key IS the adoption endpoint: publish claims under
        # the address siblings fetch /v1/prefix from
        import socket
        server.replica_id = ("http://" + socket.gethostname()
                             + f":{frontend.port}")
    # re-stamp the readiness marker now that the front door listens
    cold_start = _ready(frontend.port, registry, boot_report, compile_s,
                        t_admit)
    _emit({"event": "serving", "slots": args.slots, "port": frontend.port,
           "cold_start": cold_start,
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


def _serve_gang(args, contract, cfg, params, mesh, registry, result,
                moe_cfg=None, longctx_ring=0) -> None:
    """Serving on a gang of processes: rank 0 runs the HTTP front door
    with ``drive=False``, and every rank runs the lock-step broadcast /
    submit / step loop (``models.serving_gang``) over an engine built
    the same way on every rank (greedy; ring prefill armed over the sp
    mesh when ``longctx_ring``). Never returns while healthy."""
    from ..models.ingress import ServingFrontend
    from ..models.serving_gang import GangServingDriver
    rank = contract["process_id"]
    server, page_stats = _make_serving_engine(args, cfg, params, mesh.device,
                                              registry, moe=moe_cfg,
                                              mesh=mesh,
                                              longctx_ring=longctx_ring)
    warmup = getattr(server, "warmup", None)
    if warmup is not None:
        # the same calls on every rank; eager under tp and ep, captured
        # under sp, whose windows carry no collective
        warmup()
    frontend = None
    if rank == 0:
        frontend = ServingFrontend(server, port=_serve_port(args),
                                   max_queue=args.queue_limit,
                                   metrics=registry)
        frontend.start(drive=False)
        frontend.mark_driven()
        with open("serving.ready", "w") as f:
            f.write(f"ok {frontend.port}\n")
        _emit({"event": "serving", "slots": args.slots,
               "port": frontend.port, "gang": True,
               **({"paged": page_stats} if page_stats else {}),
               **_device_report(server), **result})
    else:
        _emit({"event": "serving", "slots": args.slots, "gang": True,
               "rank": rank, **_device_report(server), **result})
    driver = GangServingDriver(
        server, frontend, num_processes=contract["num_processes"],
        process_id=rank, mesh=mesh, decode_window=args.decode_window)
    beat = {"n": 0}

    def on_heartbeat(stats):
        beat["n"] += 1
        _emit({"event": "heartbeat", "n": beat["n"], **stats,
               "collectives": mesh.collectives,
               "collective_s": round(mesh.collective_s, 4),
               **_device_report(server)})

    driver.run(heartbeat_s=args.serve_interval, on_heartbeat=on_heartbeat)


def _serve_router(args) -> dict:
    """The fleet front door (``SERVE_ROLE=router``, ``dist/fleet.yml``):
    prefix-affinity consistent-hash routing across the decode replicas of
    ``--route-replicas``, per-tenant token-bucket admission from
    ``--tenant-classes``, the streaming relay with health- and
    load-aware spill (``models.router``). Never returns while healthy.

    The router carries no model: ``--page-size`` only parameterizes the
    affinity hash and MUST match the decode tier's page size, or requests
    hash to keys the replicas' radixes never cache under. Resizes of the
    decode tier land through ``POST /v1/replicas``."""
    from ..models.router import Router, parse_qos_classes
    replicas = [p.strip() for p in args.route_replicas.split(",")
                if p.strip()]
    try:
        classes = parse_qos_classes(args.tenant_classes)
    except ValueError as e:
        # a bad knob must not crash-loop the front door: serve with
        # admission wide open and say so
        _emit({"event": "router_config_error", "error": str(e),
               "tenant_classes": args.tenant_classes})
        classes = {}
    router = Router(replicas, port=_serve_port(args),
                    page_size=args.page_size,
                    affinity_pages=args.route_affinity_pages,
                    vnodes=args.route_vnodes, classes=classes,
                    policy=args.route_policy,
                    spill_pressure=args.route_spill_pressure,
                    spill_floor=args.route_spill_floor,
                    max_tenants=args.tenant_max_tracked).start()
    with open("serving.ready", "w") as f:
        f.write(f"ok {router.port}\n")
    _emit({"event": "serving", "role": "router", "port": router.port,
           "replicas": replicas, "policy": args.route_policy,
           "classes": sorted(classes)})
    i = 0
    while True:
        time.sleep(args.serve_interval)
        i += 1
        try:
            # what this heartbeat adds to the reference's: proof that
            # the router never touched the card
            _emit({"event": "heartbeat", "n": i, "role": "router",
                   **router.stats(),
                   "cuda_initialized": torch.cuda.is_initialized()})
        except Exception as e:
            _emit({"event": "heartbeat_error", "n": i, "error": str(e)})


def _serve_disagg(args, cfg, params, dev, registry, boot_report, result,
                  moe_cfg=None) -> bool:
    """A disaggregated serving tier (``--serve-role prefill|decode``,
    ``dist/disagg.yml``); never returns while healthy. The prefill tier
    answers ``POST /v1/prefill`` with packed page spans
    (``models.disagg.PrefillWorker``); the decode tier warms up, runs the
    client front door with ``drive=False`` and a ``DisaggCoordinator``
    shipping prompts to ``--serve-peer`` and adopting the returned pages
    on pages free. A config the tier cannot run (no ``--pages``, an
    infeasible paged engine, a decode tier without a peer) emits
    ``disagg_fallback`` and returns False: the caller serves co-located.
    A peer that dies later degrades per request (``peer_fallbacks``)."""
    from ..models.disagg import DisaggCoordinator, PrefillWorker
    from ..models.ingress import ServingFrontend
    role = args.serve_role
    if not args.pages:
        _emit({"event": "disagg_fallback", "role": role,
               "reason": "disagg tiers are paged-only: set "
                         "--pages/SERVE_PAGES"})
        return False
    t_compile = time.perf_counter()
    engine, page_stats = _make_serving_engine(args, cfg, params, dev,
                                              registry, moe=moe_cfg)
    if page_stats is None:
        _emit({"event": "disagg_fallback", "role": role,
               "reason": "paged engine infeasible (see paged_fallback)"})
        return False
    if role == "prefill":
        compile_s = time.perf_counter() - t_compile
        t_admit = time.perf_counter()
        worker = PrefillWorker(engine, port=_serve_port(args),
                               metrics=registry).start()
        cold_start = _ready(worker.port, registry, boot_report, compile_s,
                            t_admit)
        _emit({"event": "serving", "role": "prefill", "port": worker.port,
               "cold_start": cold_start, "paged": page_stats,
               **_device_report(engine), **result})
        i = 0
        while True:
            time.sleep(args.serve_interval)
            i += 1
            try:
                _emit({"event": "heartbeat", "n": i, "role": "prefill",
                       **engine.page_stats(), **_device_report(engine)})
            except Exception as e:
                _emit({"event": "heartbeat_error", "n": i,
                       "error": str(e)})
    peer = args.serve_peer.strip()
    if not peer:
        _emit({"event": "disagg_fallback", "role": role,
               "reason": "no --serve-peer/SERVE_PEER: serving "
                         "co-located"})
        return False
    engine.warmup()
    compile_s = time.perf_counter() - t_compile
    t_admit = time.perf_counter()
    frontend = ServingFrontend(engine, port=_serve_port(args),
                               max_queue=args.queue_limit,
                               decode_window=args.decode_window,
                               metrics=registry)
    frontend.start(drive=False)
    coord = DisaggCoordinator(engine, frontend, peer,
                              decode_window=args.decode_window).start()
    cold_start = _ready(frontend.port, registry, boot_report, compile_s,
                        t_admit)
    _emit({"event": "serving", "role": "decode", "port": frontend.port,
           "peer": peer, "peers": coord.peers, "cold_start": cold_start,
           "paged": page_stats, **_device_report(engine), **result})
    i = 0
    while True:
        time.sleep(args.serve_interval)
        i += 1
        try:
            _emit({"event": "heartbeat", "n": i, "role": "decode",
                   **frontend.stats(), "load": frontend.load_gauges(),
                   "paged": engine.page_stats(), "disagg": coord.stats(),
                   **_device_report(engine)})
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


def _train_specs(params, specs, mesh) -> dict:
    """The gang checkpoint's layout of a sharded train tree (over tp, ep
    or pp): ``specs`` (the live tree's) and ``disk_specs`` (the
    reference's, whose optimizer state is placed by shape:
    ``train.opt_state_specs``). With no leaf sharded, nothing: every
    leaf whole."""
    from ..models import train
    if mesh is None or all(mesh.shape[a] == 1 for a in ("tp", "ep", "pp")):
        return {}
    return {"mesh": mesh,
            "specs": {"params": specs,
                      "opt_state": train.moment_specs(specs)},
            "disk_specs": {"params": specs,
                           "opt_state": train.opt_state_specs(params, specs,
                                                              mesh)}}


def _restore_train(out_dir: str, params, opt_state, step: int,
                   layout=None):
    """``(params, opt_state)`` of ``step`` under ``out_dir``, restored
    into the live tree's structure, dtypes and device (``layout``:
    :func:`_train_specs`, none for a tree every rank holds whole)."""
    from ..models import train
    from ..parallel import checkpoint as ckpt
    tree = ckpt.restore_sharded(out_dir, _train_tree(params, opt_state),
                                step, **(layout or {}))
    return tree["params"], train.opt_state_from_tree(tree["opt_state"])


def _peak_mem(dev: torch.device) -> dict:
    """Peak device memory (CUDA only): what the port's training results
    add to the reference's."""
    if dev.type != "cuda":
        return {}
    return {"peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _train_device_report(dev: torch.device) -> dict:
    """The flash-attention kernels' launches in this process and the peak
    device memory (CUDA only)."""
    from ..ops import flash_attention as fa
    if dev.type != "cuda":
        return {}
    return {"launches": {name: getattr(fa, name).launches for name in (
                "flash_attention_fwd", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq")}, **_peak_mem(dev)}


def run_mnist(args) -> dict:
    """The MNIST MLP on one device on synthetic MNIST-shaped data (no
    dataset download): a new batch of 256 each step from a generator on
    the device, params-only checkpoints every ``steps // 4`` steps and at
    the end, and a resume from the newest one with a fresh optimizer
    state, as in the reference. On a gang each process trains alone (the
    reference forms no mesh) and resumes at the newest step every
    process holds."""
    from .._device import resolve_device
    from ..models import mlp, train
    from ..parallel import checkpoint as ckpt
    from ..parallel import distributed

    # on a gang every process trains alone, as in the reference (no
    # mesh); the process group still forms from the contract
    contract = distributed.initialize()
    dev = resolve_device(args.device)
    cfg = mlp.MLPConfig(in_dim=784, hidden=(512, 256), n_classes=10)
    params = mlp.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = train.make_optimizer(lr=1e-3)
    step_fn = train.make_train_step(lambda p, b: mlp.loss_fn(cfg, p, b), opt)
    opt_state = train.init_opt_state(opt, params)

    start = 0
    if args.out and (resume := ckpt.latest_step(args.out)) is not None:
        params = ckpt.restore_sharded(args.out, {"params": params},
                                      resume)["params"]
        opt_state = train.init_opt_state(opt, params)
        start = resume
        _emit({"event": "resumed", "step": start})

    def save(step):
        os.makedirs(args.out, exist_ok=True)
        ckpt.save_sharded(args.out, step, {"params": params})

    gen = torch.Generator(device=dev).manual_seed(1)
    batch = 256
    t0 = time.perf_counter()
    loss = None
    for step in range(start, args.steps):
        x = torch.randn((batch, 784), generator=gen, device=dev)
        y = torch.randint(0, 10, (batch,), generator=gen, device=dev,
                          dtype=torch.int32)
        params, opt_state, out = step_fn(params, opt_state, (x, y))
        loss = out["loss"]
        if args.out and (step + 1) % max(1, args.steps // 4) == 0:
            save(step + 1)
    loss = float(loss) if loss is not None else 0.0
    _sync(dev)
    dt = time.perf_counter() - t0
    steps_run = max(args.steps - start, 1)
    result = {"workload": "mnist", "steps": steps_run, "final_loss": loss,
              "examples_per_sec": round(batch * steps_run / dt, 1),
              "process_id": contract["process_id"], **_peak_mem(dev)}
    if args.out:
        save(args.steps)
    return result


def _resnet_tree(params, opt_state, state) -> dict:
    """What a resnet checkpoint holds, in the reference's layout."""
    from ..models import train
    return {"params": params, "opt_state": train.opt_state_tree(opt_state),
            "state": state}


def run_resnet(args) -> dict:
    """Data-parallel ResNet training: the reference's trainer over
    ``MeshSpec(dp=n // slices, dcn=slices)`` (``MEGASCALE_NUM_SLICES``;
    ``n`` the gang's processes, one device each). Each process draws its
    local shard of the global batch, one fixed synthetic ImageNet-shaped
    batch ``[batch, 224, 224, 3]`` bf16 and its labels, from generators
    seeded as the reference's keys (``1 + pid``, ``100 + pid``; torch
    draws other numbers); batch norm takes its statistics over the global
    batch of ``batch * n`` and the step averages the gradients over
    ``dp``. The warm-up step is a real update on the fresh init; a resume
    restores the full state (params, optimizer state and batch-norm
    statistics) over the warm-up's outputs at the newest step every
    process holds, so a fresh ``--steps N`` saves Adam count ``N + 1``
    and the two packages resume each other's checkpoints. Every process
    saves the whole replicated state to its own ``step-N-p{rank}``."""
    from ..models import resnet, train
    from ..parallel import checkpoint as ckpt

    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    n = _gang_size()
    contract, mesh = _train_mesh(args.device, n // num_slices,
                                 dcn=num_slices)
    dev = mesh.device
    if dev.type == "cuda":
        # the shapes never change: let cuDNN time each conv's algorithms
        # once, as XLA autotunes the reference's
        torch.backends.cudnn.benchmark = True
    cfg = resnet.ResNetConfig(depth=args.depth, n_classes=1000)
    params, state = resnet.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = train.make_optimizer(lr=args.lr or 0.1)
    step_fn = train.make_train_step(
        lambda p, b: resnet.loss_fn(cfg, p, b[0], b[1], mesh=mesh), opt,
        has_aux_state=True, mesh=mesh)
    opt_state = train.init_opt_state(opt, params)
    pid = contract["process_id"]
    global_batch = args.batch * contract["num_processes"]
    x = torch.randn((args.batch, 224, 224, 3), dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(1 + pid),
                    device=dev)
    y = torch.randint(0, 1000, (args.batch,), dtype=torch.int32,
                      generator=torch.Generator(device=dev).manual_seed(
                          100 + pid), device=dev)

    # the warm-up is a real update; a resume restores over its outputs
    params, opt_state, state, out = step_fn(params, opt_state,
                                            (state, (x, y)))
    float(out["loss"])
    start = 0
    if args.out and (rstep := ckpt.latest_step(args.out)) is not None:
        tree = ckpt.restore_sharded(
            args.out, _resnet_tree(params, opt_state, state), rstep)
        params, state = tree["params"], tree["state"]
        opt_state = train.opt_state_from_tree(tree["opt_state"])
        start = rstep
        _emit({"event": "resumed", "step": start})

    def save(step):
        ckpt.save_sharded(args.out, step,
                          _resnet_tree(params, opt_state, state))

    steps_run = max(args.steps - start, 0)
    ckpt_every = max(1, args.steps // 4)
    _sync(dev)
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        params, opt_state, state, out = step_fn(params, opt_state,
                                                (state, (x, y)))
        if args.emit_every and (step + 1) % args.emit_every == 0:
            # a host sync a step: opt-in, as in the reference
            _emit({"event": "progress", "step": step + 1,
                   "loss": float(out["loss"])})
        if args.out and (step + 1) % ckpt_every == 0:
            save(step + 1)
    _sync(dev)
    dt = time.perf_counter() - t0
    if steps_run == 0:
        # resumed at or past the target: nothing ran, and `out` is the
        # discarded warm-up of a fresh init
        loss, ips = None, 0.0
    else:
        loss = float(out["loss"])
        ips = x.shape[0] * steps_run / dt
        if args.out:
            save(args.steps)
    return {"workload": "resnet", "depth": args.depth, "steps": steps_run,
            "final_loss": loss, "global_batch": global_batch,
            "images_per_sec_per_chip": round(ips, 2), "process_id": pid,
            **_mesh_report(mesh), **_peak_mem(dev)}


def run_llama_train(args) -> dict:
    """LM training of the tiny Llama on one device: the reference's
    dp-sp-tp variant, whose ``divisor_at_most`` clamps every axis to 1 on
    one device (mesh dp=sp=tp=1), with its optimizer, warm-up, resume,
    guarded loop and report. The warm-up step runs on the fresh init; a
    fresh run keeps its update (so a fresh ``--steps N`` saves counts
    N + 1), a resumed run overwrites it with the newest checkpoint under
    ``--out``.

    The reference trains under a mesh, where its ``auto`` attention is
    dense (``models/llama.py::_make_attn_fn``) on one device: ``--attn
    auto`` is dense here too, and ``--attn flash`` takes the
    flash-attention kernels; ``--attn ring`` and ``ulysses`` run their
    one-rank forms.

    On a gang of ``n`` processes the axes follow the reference's rule:
    ``sp`` (``--sp``, by default 2 on an even gang) and ``tp`` (``--tp``)
    clamped to divisors of ``n``, ``dp`` the rest; ``--attn auto`` is
    ``ring`` when ``sp > 1``, and ``--ring-layout zigzag`` degrades to
    ``contiguous`` unless the attention is the ring and ``--seq``
    divides by ``2 sp``. The mesh is ``MeshSpec(dp, sp, tp)``: each rank
    draws the whole init and keeps its Megatron shards
    (``llama.param_specs``; replicated over dp and sp), the batch is
    ``max(2 * dp, 1)`` rows that every process holds, each dp coordinate
    backpropagating its own and each sp rank its sequence shard of them
    (``llama.loss_fn``), and the gang checkpoint holds each rank's shards
    as the reference's processes write them (the optimizer state placed
    by shape, ``train.opt_state_specs``). The result's ``mesh`` is the
    reference's report, ``{"dp", "sp", "tp"}`` and ``ring_layout`` under
    the ring."""
    from ..models import llama, train

    if str(os.environ.get("RESHARD_ENABLE", "0")).strip().lower() \
            not in ("", "0", "false", "no"):
        raise NotPorted("reshard_not_ported", "RESHARD_ENABLE: restart-free "
                        "resharding is not ported yet (ROADMAP Queue 1 item "
                        "10)")
    n = _gang_size()
    # --pp is checked first, as in the reference
    if args.pp > 1:
        return _llama_train_pipelined(args, n)
    if args.ep > 1:
        return _llama_train_moe(args, n)
    sp = (_divisor_at_most(args.sp, n) if args.sp > 0
          else (2 if n % 2 == 0 else 1))
    tp = _divisor_at_most(args.tp, n // sp) if args.tp > 0 else 1
    dp = n // (sp * tp)
    seq = args.seq
    attn = args.attn if args.attn != "auto" else (
        "ring" if sp > 1 else "auto")
    ring_layout = args.ring_layout
    if ring_layout == "zigzag" and (attn != "ring" or seq % (2 * sp)):
        # an incompatible layout degrades, not crash-loops the gang
        ring_layout = "contiguous"
    contract, mesh = _train_mesh(args.device, dp, tp, sp=sp)
    dev = mesh.device
    cfg = llama.LlamaConfig.tiny(
        attn_impl="dense" if attn == "auto" else attn, max_seq=seq + 1,
        ring_layout=ring_layout, fused_ce=_fused_ce(args))
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        mesh=mesh)
    # every rank holds the whole batch (the reference's batch_spec=None);
    # the step takes this rank's rows
    toks = _train_tokens(cfg, max(2 * dp, 1), seq, dev)
    mesh_report = {"dp": dp, "sp": sp, "tp": tp}
    if attn == "ring":
        mesh_report["ring_layout"] = ring_layout
    return _llama_train_loop(
        args, contract, mesh, cfg, lambda p, b: llama.loss_fn(cfg, p, b, mesh),
        llama.param_specs(cfg), params, toks, mesh_report, attn,
        train.dp_rows(toks.shape[0], mesh)[1])


def _train_tokens(cfg, rows: int, seq: int, dev: torch.device
                  ) -> torch.Tensor:
    """The fixed training batch, ``rows`` x ``seq + 1`` tokens from a
    torch generator seeded 1 on the rank's device (every rank draws the
    same)."""
    return torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.int32, device=dev)


def _llama_train_pipelined(args, n: int) -> dict:
    """Pipeline-parallel LM training, the reference's
    ``_llama_train_pipelined``: ``pp`` (``--pp`` clamped to a divisor of
    the gang) stages of the tiny Llama's trunk at ``max(4, 2 pp)``
    layers over ``MeshSpec(dp=n // pp, pp=pp)``, ``max(2, pp)``
    microbatches of two rows each through the GPipe schedule
    (``llama.loss_fn_pipelined``), every rank computing the whole batch;
    each rank holds its stage of the ``[pp, L/pp, ...]`` stacks."""
    from ..models import llama

    pp = _divisor_at_most(args.pp, n)
    contract, mesh = _train_mesh(args.device, n // pp, pp=pp)
    dev = mesh.device
    seq = args.seq
    cfg = llama.LlamaConfig.tiny(attn_impl="dense", max_seq=seq + 1,
                                 n_layers=max(4, pp * 2),
                                 fused_ce=_fused_ce(args))
    n_micro = max(2, pp)
    specs = llama.pipeline_param_specs(cfg)
    params = llama.shard_params(llama.stack_pipeline_params(
        llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev), pp), mesh, cfg, specs)
    toks = _train_tokens(cfg, n_micro * 2, seq, dev)
    return _llama_train_loop(
        args, contract, mesh, cfg,
        lambda p, b: llama.loss_fn_pipelined(cfg, p, b, mesh, n_micro),
        specs, params, toks, {"pp": pp, "microbatches": n_micro}, "dense",
        toks.shape[0])


def _llama_train_moe(args, n: int) -> dict:
    """Expert-parallel LM training, the reference's ``_llama_train_moe``:
    the tiny Llama's FFNs replaced by ``ep * max(1, ceil(4 / ep))``
    experts (``--moe-routing``) sharded over ``ep`` (``--ep`` clamped to
    a divisor of the gang) in ``MeshSpec(dp=n // ep, ep=ep)``, 4 rows
    that every rank computes whole (``llama.loss_fn_moe``)."""
    from ..models import llama
    from ..parallel.moe import MoEConfig

    ep = _divisor_at_most(args.ep, n)
    contract, mesh = _train_mesh(args.device, n // ep, ep=ep)
    dev = mesh.device
    seq = args.seq
    # the experts must divide over ep
    num_experts = ep * max(1, -(-4 // ep))
    cfg = llama.LlamaConfig.tiny(attn_impl="dense", max_seq=seq + 1,
                                 fused_ce=_fused_ce(args))
    moe_cfg = MoEConfig(num_experts=num_experts, routing=args.moe_routing)
    params = llama.init_moe_params(
        cfg, num_experts, torch.Generator(device=dev).manual_seed(0),
        device=dev, mesh=mesh)
    toks = _train_tokens(cfg, 4, seq, dev)
    return _llama_train_loop(
        args, contract, mesh, cfg,
        lambda p, b: llama.loss_fn_moe(cfg, p, b, mesh, moe_cfg),
        llama.moe_param_specs(cfg), params, toks,
        {"dp": n // ep, "ep": ep, "experts": num_experts,
         "routing": args.moe_routing}, "dense", toks.shape[0])


def _llama_train_loop(args, contract, mesh, cfg, loss_fn, specs, params,
                      toks, mesh_report, attn, rows: int) -> dict:
    """What every llama-train variant shares, as the reference's
    ``_llama_train_loop``: the optimizer, the warm-up step, the resume
    from the gang checkpoint under ``--out``, the guarded loop under the
    fault sentinel, and the report. ``rows`` is what a rank's step
    splits for ``--grad-accum`` (its dp rows, or the whole batch)."""
    from ..models import train
    from ..parallel import checkpoint as ckpt
    from . import sentinel as sentinel_mod

    dev = mesh.device
    seq = toks.shape[1] - 1
    grad_accum = max(1, args.grad_accum)
    if grad_accum > 1 and (toks.shape[0] % grad_accum or rows % grad_accum):
        # degrade, don't crash-loop the gang, as the reference; here
        # each rank splits its own rows
        _emit({"event": "grad_accum_fallback",
               "requested": grad_accum, "batch": int(toks.shape[0]),
               **({"rows_per_rank": rows} if rows != toks.shape[0]
                  else {})})
        grad_accum = 1
    opt = train.make_optimizer(lr=1e-3, warmup=5,
                               decay_steps=max(args.steps, 10))
    step = train.make_train_step(
        loss_fn, opt, grad_accum=grad_accum, mesh=mesh, batch_spec=None,
        param_spec_tree=specs)
    opt_state = train.init_opt_state(opt, params)
    layout = _train_specs(params, specs, mesh)
    params, opt_state, out = step(params, opt_state, toks)     # warm-up
    float(out["loss"])
    start = 0
    resumed = False
    if args.out and (resume_step := ckpt.latest_step(args.out)) is not None:
        t_r = time.perf_counter()
        params, opt_state = _restore_train(args.out, params, opt_state,
                                           resume_step, layout)
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
            ckpt.save_sharded(args.out, i + 1, _train_tree(params, opt_state),
                              **layout)
            _emit({"event": "checkpoint", "step": i + 1})
        return out

    def save(i):
        if args.out:
            ckpt.save_sharded(args.out, i, _train_tree(params, opt_state),
                              **layout)
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
                                           restore_step, layout)
        return restore_step

    try:
        stopped, end_step = sentinel_mod.guarded_loop(
            sent, start, args.steps, run_step,
            lambda result: float(result["loss"]), save, restore, emit=_emit)
    finally:
        sent.uninstall()
    _sync(dev)
    dt = time.perf_counter() - t0
    if stopped == "preempted":
        # flushed by guarded_loop; main() exits 143
        return {"workload": "llama-train", "attn": attn, "seq": seq,
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
                              _train_tree(params, opt_state), **layout)
    return {"workload": "llama-train", "attn": attn, "seq": seq,
            "fused_ce": bool(cfg.fused_ce), "grad_accum": grad_accum,
            "mesh": mesh_report, "final_loss": loss,
            "steps_run": steps_run,
            "tokens_per_sec": (round(
                toks.shape[0] * seq * steps_run / dt, 1) if steps_run
                else 0.0),
            "process_id": contract["process_id"], **_mesh_report(mesh),
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
    (``models.speculative.save_draft``). On a gang of ``n`` processes it
    trains over ``MeshSpec(dp=n)``: every process holds the whole batch
    and backpropagates its rows, the gradients weighted by each rank's
    share of them, so the step is one process's over the whole batch;
    every process saves its own checkpoint and draft to its own
    volume."""
    from torch.profiler import record_function

    from ..models import train
    from ..models.speculative import distill_loss, draft_student, save_draft
    from ..parallel import checkpoint as ckpt

    contract, mesh = _train_mesh(args.device, _gang_size())
    dev = mesh.device
    cfg_t = _target_config(args)
    seq = min(args.seq, cfg_t.max_seq)
    temp = max(float(args.distill_temp), 1e-3)
    layers = max(1, min(args.draft_layers, cfg_t.n_layers - 1))
    params_t = _init_target(cfg_t, dev)
    cfg_d, params_d = draft_student(cfg_t, params_t, layers)
    # every rank holds the whole batch (the reference's batch_spec=None);
    # the step takes this rank's rows and weighs its gradient by them
    toks = torch.randint(0, cfg_t.vocab_size, (max(args.batch, 1), seq),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.int32, device=dev)
    loss_fn = distill_loss(cfg_t, params_t, cfg_d, temp)
    opt = train.make_optimizer(lr=1e-3, warmup=5,
                               decay_steps=max(args.steps, 10))
    step = train.make_train_step(loss_fn, opt, mesh=mesh, batch_spec=None)
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
            "process_id": contract["process_id"], **_mesh_report(mesh),
            **device_report}


WORKLOADS = {"mnist": run_mnist, "resnet": run_resnet, "llama": run_llama,
             "llama-train": run_llama_train, "distill": run_distill}


def build_parser() -> argparse.ArgumentParser:
    """The reference parser's flags of the ported workloads (same names,
    defaults and env knobs) plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("workload", choices=sorted(WORKLOADS))
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:N or "
                        "cpu); never falls back to the CPU on its own")
    p.add_argument("--steps", type=int, default=20,
                   help="mnist, resnet, llama-train, distill: optimizer "
                        "steps")
    p.add_argument("--batch", type=int, default=32,
                   help="resnet: images a step; distill: sequences a step")
    p.add_argument("--depth", type=int, default=50,
                   help="resnet depth (18 for CPU smoke tests)")
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
                   help="llama --serve --pages: host KV tier capacity in "
                        "pages; evicted radix pages demote there (0 = off)")
    p.add_argument("--kv-tier-disk-dir",
                   default=os.environ.get("KV_TIER_DISK_DIR", ""),
                   help="llama --serve --pages: directory of the disk KV "
                        "tier the host tier spills to (empty = none)")
    p.add_argument("--kv-tier-disk-pages", type=int,
                   default=int(os.environ.get("KV_TIER_DISK_PAGES",
                                              "0")),
                   help="llama --serve --pages: disk KV tier capacity in "
                        "pages (overflow drops the coldest frame)")
    p.add_argument("--prefix-directory", type=float,
                   default=float(os.environ.get("PREFIX_DIRECTORY",
                                                "0")),
                   help="llama --serve --pages: prefix-directory staleness "
                        "window in seconds; > 0 publishes this replica's "
                        "cached chains and adopts prefixes from siblings' "
                        "/v1/prefix (0 = off)")
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
                        "chunk routed through parallel/moe.py (dist/moe.yml;"
                        " over ep on a gang). Without --pages, or with "
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
                   help="llama --serve --prefill-seq-parallel: the sp "
                        "axis of ring prefill; 0 = the gang's size (the "
                        "only size accepted: another is a coded "
                        "longctx_fallback)")
    p.add_argument("--prefill-seq-parallel",
                   default=os.environ.get("PREFILL_SEQ_PARALLEL",
                                          "false"),
                   help="llama --serve --pages on a gang: true prefills "
                        "prompts >= 2*prefill_chunk in ONE sequence-"
                        "parallel tick (llama.prefill_ring over the sp "
                        "axis, dist/longctx.yml); disqualified configs "
                        "emit longctx_fallback and prefill in chunks")
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
                   help="llama --serve: tier role. 'prefill' answers "
                        "/v1/prefill with packed KV page spans, "
                        "chunked prefill flat-out; 'decode' runs the "
                        "client front door and adopts pages shipped "
                        "from --serve-peer (dist/disagg.yml); both need "
                        "--slots and --pages, else disagg_fallback and "
                        "co-located serving; 'router' "
                        "runs the model-free fleet front door — "
                        "prefix-affinity routing across "
                        "--route-replicas (dist/fleet.yml, "
                        "models/router.py); the default serves both "
                        "phases co-located on one engine")
    p.add_argument("--route-replicas",
                   default=os.environ.get("ROUTE_REPLICAS", ""),
                   help="llama --serve --serve-role router: decode "
                        "replica base URLs, comma-separated (from "
                        "`tpuctl endpoints serve`). Resizes land at "
                        "runtime via POST /v1/replicas")
    p.add_argument("--route-policy",
                   default=os.environ.get("ROUTE_POLICY", "affinity"),
                   choices=["affinity", "random"],
                   help="router: prefix-affinity consistent hashing, "
                        "or uniform random (the A/B control arm)")
    p.add_argument("--route-affinity-pages", type=int,
                   default=int(os.environ.get("ROUTE_AFFINITY_PAGES",
                                              "1")),
                   help="router: full prompt pages hashed into the "
                        "affinity key (1 = the shared system-prompt "
                        "page; more pins deeper prefixes)")
    p.add_argument("--route-vnodes", type=int,
                   default=int(os.environ.get("ROUTE_VNODES", "64")),
                   help="router: virtual nodes per replica on the "
                        "hash ring (more = smoother balance, bigger "
                        "ring)")
    p.add_argument("--route-spill-pressure", type=float,
                   default=float(os.environ.get("ROUTE_SPILL_PRESSURE",
                                                "0.85")),
                   help="router: back-pressure (scheduler/elastic.py "
                        "backpressure() over the replica's /v1/healthz "
                        "load gauges) above which the affinity target "
                        "counts as hot and requests spill to the "
                        "least-loaded healthy replica")
    p.add_argument("--route-spill-floor", type=int,
                   default=int(os.environ.get("ROUTE_SPILL_FLOOR", "0")),
                   help="router: minimum QoS-class priority allowed to "
                        "spill on HOT (spill on DOWN applies to all "
                        "classes — availability is not a paid feature)")
    p.add_argument("--tenant-classes",
                   default=os.environ.get("TENANT_CLASSES", ""),
                   help="router: per-tenant QoS classes, "
                        "name:priority:rate:burst[:ttft_slo_ms] "
                        "comma-separated, e.g. "
                        "'gold:10:50:100:250,free:1:2:4'. priority "
                        "shares the scheduler's priority: integer "
                        "scale; rate/burst parameterize each tenant's "
                        "token bucket; empty = admission wide open")
    p.add_argument("--tenant-max-tracked", type=int,
                   default=int(os.environ.get("TENANT_MAX_TRACKED",
                                              "4096")),
                   help="router: LRU cap on tracked per-tenant state "
                        "(buckets + counters), bounding memory against "
                        "unique-X-Tenant floods; an idle tenant "
                        "evicted past the cap restarts from a fresh "
                        "burst on return")
    p.add_argument("--serve-peer",
                   default=os.environ.get("SERVE_PEER", ""),
                   help="--serve-role decode: the prefill tier's base "
                        "URL(s), http://host:port, comma-separated for "
                        "several (round-robin with /v1/healthz-gated "
                        "per-peer fallback). Empty degrades loudly to "
                        "co-located serving (disagg_fallback)")
    p.add_argument("--attn", default="auto",
                   choices=["auto", "dense", "flash", "ring", "ulysses"],
                   help="llama-train: attention (auto: ring when sp > 1, "
                        "else dense)")
    p.add_argument("--ring-layout", default="contiguous",
                   choices=["contiguous", "zigzag"],
                   help="llama-train --attn ring: zigzag balances causal "
                        "work across the ring (each shard holds one "
                        "early + one late chunk); needs seq %% (2*sp) "
                        "== 0, else degrades to contiguous")
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
                   help="llama-train: pipeline stages (> 1: the pipelined "
                        "variant, checked before --ep)")
    p.add_argument("--ep", type=int, default=0,
                   help="llama-train: expert-parallel size (> 1: the MoE "
                        "variant)")
    p.add_argument("--lr", type=float, default=0.0,
                   help="resnet: learning-rate override (0 = default "
                        "0.1)")
    p.add_argument("--emit-every", type=int, default=0,
                   help="resnet, distill: emit a {event: progress, step, "
                        "loss} line every N steps (0 = off; a host sync "
                        "each time)")
    p.add_argument("--out", default="",
                   help="the task's volume: created if absent; --serve "
                        "restores the newest sharded checkpoint in it (and "
                        "serves it with WEIGHT_SERVE_PORT); mnist, resnet, "
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
    if num_slices > 1 and args.workload != "resnet":
        # only the data-parallel trainer spans slices in the reference
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
