#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dcos_commons_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every kernel of ``dcos_commons_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print the card;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes of the main paths and time the kernel, the plain version, one
   library call as a yardstick, and the card's bound for the same work:
   paged flash-decode (Llama-3-8B heads, B=8 ragged streams, page sizes
   64 and 128, bf16 and int8 pages, and 16 in bf16); slot-cache
   flash-decode (Llama-3-8B heads, B=8 slots of a 2048-position cache,
   bf16 and int8, and a case in each with a slot past the cache and one
   empty), each decode case with its share of the bound, a second call on
   other inputs and 20 more launches that must give the first call's
   bits; flash-attention forward,
   dK/dV and dQ (the Llama-400m train step's B=16, S=511, H=12, KV=6,
   D=128, Llama-3-8B heads B=2, S=2048, H=32, KV=8, and the distill
   step's B=32, S=256 at those heads), and the forward alone at the
   slot-prefill bucket (B=8, S=2048, Llama-3-8B heads), each
   flash-attention case with its share of the bound, and the port's
   whole backward (rowsum pass and both kernels) beside SDPA's;
3. serve Llama-3-8B (full width and depth, random bf16 weights from a
   seed) through ``PagedServer`` with a compile cache, after
   ``warmup()``: about a dozen requests, two sharing a long prefix,
   decode windows 1 and 8, every window a CUDA graph; launch counts are
   zeroed just before and read just after (a graph replay counts the
   launches it holds); then one decode step through the kernel is held
   against the same step through the dense gather; then, from one
   snapshot of 8 live streams, 6 windows of 8 steps run through the
   eager model-function loop driven by hand and through the graphs,
   each window timed unprofiled, and must give the same tokens and
   lengths; then a second engine of the same key warms up;
7. (right after phase 3, on its weights) speculative decoding: the same
   ``PagedServer`` armed with ``truncate_layers(cfg, params, 1)`` at k=4
   serves phase 3's 12 requests, each stream teacher-forced through the
   target (every token's logit within ``NEAR_TIE_ATOL`` of the top at
   its position, so it leaves phase 3's solo stream only at a near-tie
   and is held after it too), kernel 2 launched
   k times a window and kernel 3 once a draft prefill; after a reset, 6
   spec windows at B=8 through the graphs and through the eager loop by
   hand must give the same tokens, ``n_emit``, lengths and live K/V rows
   (pool and draft cache); the self-draft (all 32 layers) serves 4 of
   the requests (three, then prefix-b alone on prefix-a's radix pages;
   each drain must accept ``SELF_DRAFT_ACCEPT_FLOOR`` of its
   proposals), then from a snapshot of those 4 streams runs eager
   windows in which every rejected proposal must sit at a near-tie of
   the verify's logits;
   then ``save_draft`` writes the 1-layer draft under
   ``build/spec_draft`` for the worker below;
11. (right after phase 7, on phase 3's weights) the KV hierarchy: 8
   tenants, each a 1,024-token system prompt (16 pages) and a 64-192
   token turn, 32 new; round 1 at once, round 2 one by one, newest
   tenant first (``serve_tier_rounds``). ``PagedServer(pages=64,
   tiers=PageTierStore(32 host pages, 96 disk pages))`` after
   ``warmup()``: every page a promote installs is bitwise the page
   before its first demote, host and disk both hit, nothing falls back
   or drops, no chain is in the radix and a tier at once, and kernel 1
   is counted over both rounds; an untiered 256-page engine gives the
   same tokens; the int8 pool repeats the byte checks for two tenants;
   after a promote, graphed windows equal the eager loop bitwise; a
   replica with an empty radix adopts round 2 from the untiered engine
   over ``POST /v1/prefix`` (pages and tokens equal); then demote,
   promote (host, disk) and adoption times with their blake2s share,
   and the time to first token by promote, by adoption and by
   recompute; then the worker with ``--pages 64 --kv-tier-host-pages 32
   --kv-tier-disk-dir DIR --kv-tier-disk-pages 96`` serves both rounds
   over HTTP with the in-process engine's round-2 tokens and tier hits
   in ``/v1/stats``;
12. (right after phase 11, on phase 3's weights) disaggregated
   prefill/decode serving, both tiers on the card over the same weights:
   a prefill tier (``PagedServer(pages=64)``) behind ``PrefillWorker``
   on 127.0.0.1 and a decode tier with phase 3's geometry (after
   ``warmup()``; it captures its windows at first use, never while the
   prefill tier works: in one process that capture fails) behind
   ``ServingFrontend(drive=False)`` and
   ``DisaggCoordinator(decode_window=8)``; phase 3's 12 requests at once
   over ``POST /v1/generate``, two streamed (7,359 prompt tokens, 119
   pages shipped): every reply phase 3's stream or off it only at a
   near-tie, every adopted page bitwise its span's, 12 spans and no
   fallback, both ledgers clean, kernel 1 counted on the decode tier and
   no kernel launched by a prefill span; then 8 prompts shipped one by
   one and adopted with 200 new tokens, graphed windows over them
   bitwise the eager loop; then a coordinator whose only peer is a
   closed port serves 2 requests co-located with their tokens; TTFT
   through the pair beside phase 3's, and each shipment split into
   prefill, gather, pack, HTTP, unpack and install ms with the blake2s
   share; then (after phase 6) the worker pair, ``--serve-role prefill
   --pages 64 --serve-port P`` and ``--serve-role decode --serve-peer
   http://127.0.0.1:P --pages 64``: phase 6's 8 requests held to the
   ``--pages 64`` worker's replies (near-tie rule), 8 spans and no
   fallback in the decode heartbeat, ``role: prefill`` in the prefill
   tier's ``/v1/healthz``, no kernel launched by the prefill process,
   both ended with SIGTERM;
13. (right after phase 12, on phase 3's weights) live migration, one
   thread driving every engine: a victim and a survivor with phase 3's
   geometry after ``warmup()``; phase 3's 12 requests on the victim in
   windows of 8 until 4 streams decode with 4 or more tokens while one
   still prefills, then ``MigrationManager(ring=HashRing, on_redirect)``
   drains the victim (DECSTATE frames, ``import_stream``,
   ``release_stream``) and the survivor takes the requests not admitted
   yet and finishes every stream: each phase 3's or off it only at a
   near-tie, ``failed`` 0, the prefilling streams resubmitted, every
   imported page bitwise its frame's, no bound tensor rebound, both
   ledgers clean, kernel 1 counted on each piece of the path from 0
   just before it to just after it (no warmup, no eager check window);
   then 8 decoding
   streams of 200 new tokens drained and graphed windows over them
   bitwise the eager loop; one stream shipped over HTTP to a
   ``MigrateReceiver``; a drain refused by a survivor with every slot
   taken (the victim finishes the stream); a sampled stream moved with
   ``adopt_rng=True`` continuing the victim's own stream in graphed
   windows; ms a page by part (gather, pack, unpack, install; blake2s
   apart) and the pause a stream; then (after phase 12's worker pair)
   the fleet of ``dist/fleet.yml``: two ``--pages -1 --page-size 64
   --prefill-chunk 64`` decode workers (8B width cut to ``FLEET_LAYERS``,
   4 of 32 layers, through ``CUT_WORKER``) and a ``--serve-role router``
   worker in front, under ``--route-policy affinity`` and under
   ``random`` (tenant classes without a TTFT SLO), then affinity under
   the deployed classes (a 500 ms TTFT SLO), each arm on a fresh pair,
   4 tenants x 3 turns one at a time: every reply equal to a direct
   call to its replica, every affinity route on its ring primary or a
   counted hot spill, each tenant on one replica and strictly more
   radix hits under affinity, a tenant past its bucket shed with 429, a
   replica swapped out and back in under 4 streams with none dropped,
   the router never initializing CUDA, kernel 1 in both workers (the
   heartbeats read around the routed traffic, never across a direct
   call);
5. (on phase 3's weights) serve Llama-3-8B through
   ``SlotServer(slots=8)`` behind the HTTP front door
   (``ServingFrontend`` on 127.0.0.1, decode window 8): a dozen
   concurrent ``POST /v1/generate`` requests, two of them streamed, then
   ``/v1/healthz`` and ``/v1/stats``, and one solo ``generate_chunked``;
   launch counts are zeroed just before and read just after; then one
   ``decode_step_slots`` through the kernel is held against the dense
   step on the live cache, and the graphed windows against the eager
   loop as in phase 3;
6. start the port's worker as the scheduler would, ``python -m
   dcos_commons_tpu_torch.frameworks.worker llama --preset 8b --serve
   --slots 8`` (Llama-3-8B in the default ``SlotServer``), send it 8
   concurrent requests (one streamed), check ``/v1/healthz``,
   ``/v1/stats`` and a heartbeat, and end it with SIGTERM; beside it the
   same with ``--pages 64`` (``PagedServer``), each in a directory of
   its own under ``build/``; each worker's launch counts are
   its own while it served (its heartbeat's less its ``serving``
   event's); then (phase 7) the worker with ``--pages 64 --spec-decode
   true --draft-checkpoint build/spec_draft --draft-k 4``: a
   ``spec_armed`` event (a ``spec_fallback`` fails), the same 8 requests,
   tokens held to the paged worker's under the near-tie rule, spec
   windows in ``/v1/stats``;
8. (right after phase 2, in a process of its own) the worker's
   ``distill --preset 8b --draft-layers 1 --batch 32 --seq 256 --steps
   20 --out DIR``: exit 0, finite falling losses, kernels 3-5 launched
   once a layer a step by the run's own counts (no attention dense), the
   checkpoint and the sealed draft saved, step time and peak memory
   beside the reckoning; then (beside phase 7's worker) the worker with
   ``--pages 64 --spec-decode true --draft-checkpoint DIR/draft``:
   ``spec_armed``, phase 6's 8 requests, every token held to the target
   under the near-tie rule, its acceptance beside the truncated draft's;
10. (after the dense 8B phases free their weights) MoE serving at
   Llama-3-8B widths with 8 experts, top-2, dropless (the Mixtral-8x7B
   routing geometry), cut to ``MOE_LAYERS`` of its 32 layers (about 32.5
   GB of random bf16 weights from the seed; the worker below too):
   ``PagedServer(moe=...)`` after ``warmup()`` drains phase 3's 12
   requests and the workers' 8, and ``generate_stepwise_moe`` decodes
   phase 3's 12 alone (kernel 2), with the kernel counts zeroed just
   before and read just after; the engine's streams, teacher-forced
   through the MoE target, must put ``MOE_NEAR_TIE_SHARE`` of their
   tokens within ``NEAR_TIE_ATOL`` of the top logit (bf16 routing flips
   let a stream leave the reference at any token: see there), and in
   fp32 at ``MOE_FP32_LAYERS`` layers of the full width every stream
   must equal ``generate_stepwise_moe``; ``moe_apply_local`` on the card
   is held to the port's CPU result in fp32, and the graphed windows at
   B=8 bitwise to the eager loop; then the worker with
   ``dist/moe.yml``'s flags (``--pages -1 --moe-experts 8
   --moe-capacity-factor 0``): a ``moe_fallback`` or ``paged_fallback``
   fails, its replies are held to the in-process engine's streams for
   the same prompts (by the same share where they leave them);
4. train ``llama_400m`` (full width and depth, bench.py's headline shape:
   batch 16 x 512 tokens, fused cross-entropy, AdamW with warmup 10):
   one warm-up step, then 10 timed steps on the same batch with the
   flash-attention launch counts zeroed just before and read just after;
   then one loss forward and backward through the kernels is held
   against the same through the dense attention path;
9. the worker's ``llama-train`` (tiny, head_dim 8; ``--attn auto`` is
   dense, as the reference's ``auto`` under its train mesh, no kernel
   launched): a fresh ``--steps 3`` (counts 4 saved), a ``--steps 5``
   that resumes at 3, and a ``--ckpt-every 1`` run SIGTERM'd after its
   first checkpoint (``sigterm``, ``preempted``, exit 143) whose
   relaunch resumes at the flushed step; then ``--attn flash --steps 2``
   through kernels 3-5 (head_dim 8 zero-padded to 64), one launch of
   each a layer a step.

14. (after phase 6) scale-up through the weight server at Llama-3-8B:
   worker A (``--pages 64 --out VOL_A`` with ``WEIGHT_SERVE_PORT``) boots
   from the init, seeds step 0, serves it and answers phase 6's 8
   requests; worker B (``--out VOL_B``, ``WEIGHT_FETCH_PEERS`` at A)
   mirrors and restores it (``source: peer``, VOL_B's step equal to
   VOL_A's) and answers them with A's replies (near-tie rule),
   kernel 1 counted around its requests; A's seed-save, B's fetch and
   restore seconds and GB/s. Cut: 2 of the 32 layers at full width
   (``CUT_WORKER``; at 32 layers the phase took 485 s, at 8 91 s, at 4
   73-91 s), so B's replies
   are held to A's. Then (after phase 4, the card free of the 8B
   weights, beside phase 10's worker) ResNet-50 at full width and
   depth: the fp32 train pass at batch 8, 224x224, card against CPU
   (logits, loss, batch-norm state, every gradient), then bf16 at batch
   256 (``BATCH_PER_HOST``): 3
   warm-up and 20 timed steps, step ms, images/s, MFU against 989 TFLOP/s
   by bench.py's 3 x 4.09 GFLOP an image, peak memory, the loss stream,
   one step's device split (convolutions, batch norm and elementwise,
   the optimizer) and idle share; then the worker's ``resnet --depth 50
   --batch 256 --steps 8 --out VOL`` (Adam count 9), its resume to 12,
   ``mnist --steps 200 --out VOL2`` and its resume to 250. No kernel is
   new in phase 14.
15. (beside phases 12 and 13a, on phase 3's weights) tensor-parallel
   serving over a process mesh: ``TP_WORLD`` (2) ranks started by
   ``parallel.distributed.launch_local`` share the card over gloo (NCCL
   refuses two ranks on one device), each drawing the 8B weights from
   the seed and keeping its Megatron shard (``init_params(mesh=)``);
   ``PagedServer(mesh=)`` at phase 3's geometry serves phase 3's 12
   requests and ``SlotServer(mesh=)`` the 4 of them in
   ``TP_SLOT_REQUESTS``, with the kernel counts zeroed just before
   and read just after on each rank (kernels 1, 2 and 3 on the rank's 16
   query and 4 KV heads); every rank's streams must equal rank 0's, and
   each, teacher-forced through the parent's single-device weights, may
   leave phase 3's solo stream only at a near-tie; then fp32 at
   ``TP_FP32_LAYERS`` (4) of the 32 layers at full width, both engines
   token-equal to the single-device fp32 engines; an eager B=8 decode
   step with the collectives' host share (two ranks sharing one card
   over gloo: not a TP speed number); the ``tp`` line. Then (after phase
   14b) the worker gang: two ``python -m
   dcos_commons_tpu_torch.frameworks.worker llama --preset 8b --serve
   --slots 8`` processes with the ``JAX_*`` contract, 8B width cut to 2
   of 32 layers (phase 14b's cut, ``CUT_WORKER``): rank 0 answers phase
   6's 8 requests, its ``/v1/stats`` carries the gang counters, rank 1's
   heartbeats ``gang_iterations``, every reply equal to the single-device
   slot engine of the cut model or off it only at a near-tie, kernels 2
   and 3 counted on each rank while it served; the ``worker_tp`` line.
   Phase 2 also holds kernels 1 and 2 at one rank's heads (B=8, H=16,
   KV=4), bf16 and int8.
16. Data-parallel training over a process mesh (``dist/resnet.yml``,
   BASELINE config #4), after phase 14a: two ranks sharing the card over
   gloo (not a DP speed). 16a: ResNet-50 at full width and depth, fp32,
   224x224, 8 images a rank, held to one process over the 16 (loss,
   batch-norm state, the stem's, a middle block's and the head's
   gradients, the update after 2 steps; one process over the 16 in
   reverse order is printed beside it as the rounding floor), params,
   moments and state bitwise equal across the ranks; then bf16 at 128
   images a rank (14a's global batch of 256): step ms, collectives a step
   and their host share, peak memory a rank. 16c: distill at Llama-3-8B
   width with the teacher cut to 2 of 32 layers, 3 rows of 256 tokens (2
   on rank 0, 1 on rank 1), each loss within 1e-3 of one process's and
   the draft's update after 3 steps held to one process's (cosine,
   largest element error; one process over the rows in reverse order
   beside it), kernels 3-5 counted on each rank; the ``dp`` line. 16b
   (beside phase 14b): two ``worker resnet --depth 50 --batch 128``
   processes under the rank contract, launched with ``--steps`` 2, then
   3 (both resume at 2), then 4 after rank 1's newest step is removed
   (both resume at 2), the same ``final_loss`` and progress on both
   ranks; the ``worker_dp`` line.
17. Tensor-parallel training over a process mesh (``dist/longctx.yml``'s
   ``worker`` pods at tp=2), after phase 14a: two ranks sharing the card
   over gloo (not a TP speed). 17a: ``llama_400m`` at phase 4's weights
   and batch (16 x 512), bf16 at full depth with ``attn_impl="flash"``,
   kernels 3-5 on each rank's 6 query and 3 KV heads, a warm-up and 3
   steps (step ms, collectives a step against the count worked out from
   the code, their host share, peak memory a rank, launches zeroed just
   before and read just after), the warm-up loss held to one process's
   bf16 loss on the whole init; then fp32 at 2 layers with dense
   attention, the first pass's loss and every gradient leaf gathered
   whole and the update after 2 steps held in rank 0 to one process of
   the port on the same weights; the norms and their moments bitwise
   equal across the ranks; the ``tp_train`` line. 17b (beside phase 16):
   two ``worker llama-train --sp 1 --tp 2 --attn flash`` processes under
   the rank contract, launched with ``--steps`` 2, 4 (both resume at 2)
   and 4 after rank 1's newest step is removed (both resume at 2 and end
   at the second launch's loss bit for bit); the ``worker_tp_train``
   line. Phase 2 also holds kernels 3-5 at one rank's heads (B=16,
   S=511, H=6, KV=3, D=128).
18. Sequence-parallel training over a process mesh (``dist/longctx.yml``'s
   ``worker`` pods at their deployed defaults, sp=2), after phase 14a:
   two ranks sharing the card over gloo (not an SP speed), no kernel on
   the deployed path (the ring's and Ulysses' tiles are plain products,
   as the reference's). 18a: ``llama_400m`` on one sequence of 8,192
   positions (B=1), each rank holding 4,096 through the whole model, for
   the ring (contiguous and zigzag), Ulysses and ``flash`` (the global
   attention: K/V gathered over sp, kernels 3-5 on the rank's queries at
   its offset, launches zeroed just before and read just after): bf16 at
   full depth, a warm-up and a step (step ms, collectives a step against
   the count from the code, their host share, peak memory a rank), the
   warm-up loss held to one process's bf16 loss; for the first three
   fp32 at 2 layers (the clip set above the
   gradient's norm), the first step's loss and gradient (its update's
   first moment over 1 - b1: the gradient reduced over sp) and the update
   after 2 steps held in rank 0 to one process of the port with dense
   attention over the whole sequence; every leaf's bit checksums equal
   on both ranks; the
   ``sp_train`` line (18a runs beside 17a). 18b (beside phase 16): two
   ``worker llama-train
   --attn ring --ring-layout contiguous --seq 8192 --sp 0 --tp 0
   --fused-ce true --grad-accum 1 --ckpt-every 1`` processes, 4 steps
   through; again, SIGTERM to both once each has checkpointed step 2
   (each flushes at its next step boundary and exits 143; a rank whose
   peer stopped a step earlier fails that step's collective, exit 1), and
   relaunched (both resume at one step and end at the through run's loss
   bit for bit); beside them ``--attn
   ulysses`` and ``--ring-layout zigzag`` at ``--seq 2048`` and ``--sp 2
   --tp 2`` on 4 ranks, each with the reference's ``mesh``; the
   ``worker_sp_train`` line. Phase 2 also holds kernels 3-5 at the
   flash case's geometry (B=1, 4,096 queries over 8,192 keys at offsets
   4,096 and 0, H=12, KV=6, D=128).
20. Ring prefill on a sequence-parallel serving gang (``dist/longctx.yml``'s
   ``server`` pod), on a thread beside phases 10 and 4 (its checks
   after): two ranks sharing the card over gloo (not an SP speed). 20a:
   Llama-3-8B width at max_seq 8,192, page 64, chunk 64, ``PagedServer(
   longctx_ring=2)`` over ``MeshSpec(sp=2)`` serving three prompts (8,160
   tokens, which pad to max_seq exactly; 3,000; 100, under the ring
   threshold, in chunks), 32 new each: in fp32 at 4 layers every rank's
   streams equal the one-device chunked engine's on the same weights and
   the long prompt's ring K/V is within ``RING_KV_RTOL`` of its chunked
   K/V; then bf16 at 8 layers, streams equal or held by the near-tie
   rule; in both, two ring prefills and no fallback, the ranks' written
   pages bitwise equal, and the ring's seconds for the long prompt
   beside the one-device chunked prefill's; kernel 1 counted on each
   rank in bf16; the ``ring_serve`` line. 20b: two ``worker llama
   --preset 8b --serve --slots 8 --pages -1 --max-seq 8192
   --prefill-seq-parallel true`` processes under the rank contract, cut
   to 8 of 32 layers: the long prompt over HTTP gets 20a's bf16 stream
   (or one held by the near-tie rule), each rank's heartbeat shows
   ``pages.longctx`` with a ring prefill and no fallback, kernel 1
   counted on each rank while it served; the ``ring_worker`` line.
   Phase 2 also holds kernel 1 at 20's decode shape (bf16 pages of 64
   over an 8,192-position span, streams up to 8,192 long, so a partial
   covers up to 1,024 positions).

Each phase's wall seconds go to stderr as it ends and into the
``phase_s`` line. Output: the ``serving``, ``serving_slots``,
``worker``, ``worker_paged``, ``worker_spec``, ``worker_distilled``,
``training``, ``distill``, ``llama_train``, ``spec``, ``moe``,
``worker_moe``, ``kv_tiers``, ``worker_kv_tiers``, ``disagg``,
``worker_disagg``, ``migrate``, ``fleet``, ``worker_peer``, ``tp``,
``worker_tp``, ``resnet``, ``worker_resnet``, ``dp``, ``worker_dp``,
``tp_train``, ``worker_tp_train``, ``sp_train``, ``worker_sp_train``,
``ep_pp_train``, ``worker_ep_pp``, ``ep_serve_fp32``,
``ep_serve_worker``, ``ring_serve``, ``ring_worker`` and ``phase_s``
lines,
the ``kernels`` line, the card's
name and power limit, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the repository
beside it, it exits non-zero and prints no result. Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16
# tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
SEED = 0
# about 25 ms of SM clock: longer than the host takes to queue a timing run
SLEEP_CYCLES = 50_000_000

# kernel vs plain version: both accumulate in fp32 and round once to
# bf16, so they differ by at most about one bf16 ulp (2^-7 relative)
KERNEL_RTOL, KERNEL_ATOL = 1e-2, 1e-3
# flash attention, kernel vs plain version: both accumulate in fp32 and
# round each output once to bf16, but the kernels round P (and dS) to bf16
# before their products, as the TPU kernel does, so an output may flip its
# last bf16 bits and the error scales with the largest value: rtol 2e-2
# plus 1e-2 of max|want| over each row of a head for O, over the tensor
# for a gradient (fa_check); lse is fp32 on both sides
FA_RTOL, FA_SCALED_ATOL, LSE_ATOL = 2e-2, 1e-2, 1e-3
# the train step, one loss forward + backward through the kernels vs the
# dense path, both bf16 over 8 layers: loss within 2e-2 (about 3 bf16
# ulps of the ~10.4 loss, carried by bf16 rounding flips in attention);
# each gradient leaf within 5e-2 relative in norm
LOSS_ATOL, GRAD_RTOL = 2e-2, 5e-2
# one decode step, kernel vs dense gather, over 32 bf16 layers: attention
# outputs differ by bf16 rounding flips, which the residual stream carries
# to the bf16-rounded logits (ulp 2^-7 near 1): allow 16 ulps there
LOGIT_ATOL = 0.125


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (the main paths find their inputs cold). A sleep kernel
    first holds the card while the host queues every launch, so the
    events time the device, not the host's gaps between launches."""
    import torch
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for the work: bytes over the memory rate or bf16
    operations over the tensor-core peak, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


# --------------------------------------------------------------- phase 1


def phase_build() -> None:
    from dcos_commons_tpu_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in build.log_path(name).read_text().splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------- phase 2

KV_LENS = (1, 63, 64, 65, 700, 2047, 1500, 333)
# slot lengths of the edge case: one past the cache, one empty
EDGE_LENS = (4096, 0, 64, 65, 700, 2047, 1500, 333)
# the other inputs of the second-call check: other lengths, one empty
OTHER_LENS = (2048, 5, 129, 1000, 0, 77, 1024, 9)
# launches that must give the same bits
REPEATS = 20


# the decode kernels' head counts: Llama-3-8B's, and one rank's share of
# them under tp=2 (phase 15: the GQA group stays 4)
HEADS_8B, HEADS_TP2 = (32, 8), (16, 4)


def decode_inputs(kind: str, int8: bool, lens, seed: int, ps: int = 64,
                  heads=HEADS_8B, span: int = 2048):
    """Kernel inputs at the 8B decode shape (H=32, KV=8, D=128, B=8; or
    ``heads`` (H, KV)): paged, (q, k, v, table, kv_len) over a shuffled
    table of a ``span``-position span; slots, (q, k, v, kv_len) over a
    2048-position cache read in place."""
    import torch
    from dcos_commons_tpu_torch.ops.quant import quantize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    (h, kv), b, d = heads, 8, 128
    span = span if kind == "paged" else 2048
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    if kind == "paged":
        mp = span // ps
        pages = b * mp + 1
        shape = (pages, ps, kv, d)
    else:
        shape = (b, span, kv, d)
    k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    if int8:
        k, v = quantize(k, axis=-1), quantize(v, axis=-1)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    if kind == "slots":
        return q, k, v, kv_len
    perm = torch.randperm(pages - 1, generator=g, device=dev)
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    return q, k, v, table, kv_len


def decode_check(name: str, got, want, lens) -> float:
    """Max abs error of a decode output against its plain version; raises
    outside KERNEL_RTOL/KERNEL_ATOL, on a non-finite value, or on a
    stream with no live position whose output is not exactly 0."""
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    dead = [i for i, n in enumerate(lens) if n <= 0]
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()) \
            or any(bool((got[i] != 0).any()) for i in dead):
        raise RuntimeError(f"{name}: {int(bad.sum())} elements off (max abs "
                           f"err {float(err.max()):.3e}), dead streams "
                           f"{dead}")
    return float(err.max())


def decode_repeat_check(name: str, run, args, other_args, plain,
                        other_lens=OTHER_LENS) -> None:
    """The second-call and determinism checks: a call on other inputs
    (other lengths, one stream empty) is right, the next call on the first
    inputs gives the first call's bits, and so do REPEATS more."""
    first = run(*args)
    other = run(*other_args)
    decode_check(f"{name} second call", other, plain(*other_args),
                 other_lens)
    for i in range(REPEATS + 1):
        if not bool((run(*args) == first).all()):
            raise RuntimeError(f"{name}: launch {i + 2} on the same inputs "
                               "differs from the first")


def flash_decode_case(ps: int, int8: bool, flush, run=None,
                      plain: bool = True, heads=HEADS_8B, span: int = 2048,
                      lens=KV_LENS, other_lens=OTHER_LENS) -> dict:
    """Kernel 1 vs its plain version at the 8B decode shape (or
    ``heads``): ragged streams of ``lens`` (then ``other_lens``) over a
    shuffled page table of ``span`` positions; ``run(q, k, v, table,
    kv_len)`` defaults to the wrapper's launch (another version of the
    source can stand in), ``plain`` False skips timing the plain
    version."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.models.llama import _gather_pages
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    (h, kv), b, d, mp = heads, 8, 128, span // ps
    q, k, v, table, kv_len = decode_inputs("paged", int8, lens,
                                           SEED + ps + int8, ps, heads, span)
    run = run or (lambda *a: fd._launch_paged(*a, d ** -0.5))
    name = f"flash_decode_paged ps={ps} int8={int8} heads={heads} span={span}"
    got = run(q, k, v, table, kv_len)
    want = fd.flash_decode_paged_reference(q, k, v, table, kv_len)
    torch.cuda.synchronize()
    max_err = decode_check(name, got, want, lens)
    decode_repeat_check(
        name, run, (q, k, v, table, kv_len),
        decode_inputs("paged", int8, other_lens, SEED + 100 + ps, ps,
                      heads, span),
        fd.flash_decode_paged_reference, other_lens)

    # yardstick: SDPA over pre-gathered (dequantized) pages, masked at
    # kv_len; timed here only, never called by the port
    kg = _gather_pages(k, table, torch.bfloat16).transpose(1, 2)
    vg = _gather_pages(v, table, torch.bfloat16).transpose(1, 2)
    span = mp * ps
    mask = (torch.arange(span, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float()
                     - want.float()).abs().max())
    iters = 50
    ms = timed_ms(lambda: run(q, k, v, table, kv_len), iters, flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_paged_reference(
        q, k, v, table, kv_len), 10, flush) if plain else None
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(n, span) for n in lens)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * mp * 4 + b * 4
    out = {"page_size": ps, "pages": "int8" if int8 else "bf16",
           "heads": list(heads), "span": span, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_err": lib_err,
           "bitwise_equal_launches": REPEATS + 2, "second_call": "ok",
           **bound(kv_bytes + io_bytes, 4 * live * h * d)}
    out["bound_share"] = out["bound_ms"] / ms
    return out


def slot_decode_case(int8: bool, kv_lens, flush, run=None,
                     plain: bool = True, heads=HEADS_8B) -> dict:
    """Kernel 2 vs its plain version at the 8B slot shape (or ``heads``):
    B=8 slots of a 2048-position cache read in place; ``run(q, k, v,
    kv_len)`` and ``plain`` as for ``flash_decode_case``."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.ops.quant import dequantize

    dev = torch.device("cuda")
    (h, kv), b, d, s = heads, 8, 128, 2048
    q, k, v, kv_len = decode_inputs("slots", int8, kv_lens, SEED + 7 + int8,
                                    heads=heads)
    run = run or (lambda *a: fd._launch_slots(*a, d ** -0.5))
    name = f"flash_decode int8={int8} lens={kv_lens} heads={heads}"
    got = run(q, k, v, kv_len)
    want = fd.flash_decode_reference(q, k, v, kv_len)
    torch.cuda.synchronize()
    max_err = decode_check(name, got, want, kv_lens)
    decode_repeat_check(name, run, (q, k, v, kv_len),
                        decode_inputs("slots", int8, OTHER_LENS, SEED + 107,
                                      heads=heads),
                        fd.flash_decode_reference)

    # yardstick: SDPA over the (dequantized) cache masked at kv_len; timed
    # here only, never called by the port
    kd = dequantize(k, torch.bfloat16) if int8 else k
    vd = dequantize(v, torch.bfloat16) if int8 else v
    kt, vt, qt = kd.transpose(1, 2), vd.transpose(1, 2), q.transpose(1, 2)
    mask = (torch.arange(s, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    live_rows = [i for i, n in enumerate(kv_lens) if n > 0]
    lib_err = float((library().transpose(1, 2).float()
                     - want.float())[live_rows].abs().max())
    iters = 50
    ms = timed_ms(lambda: run(q, k, v, kv_len), iters, flush)
    plain_ms = timed_ms(lambda: fd.flash_decode_reference(q, k, v, kv_len),
                        10, flush) if plain else None
    library_ms = timed_ms(library, iters, flush)

    live = sum(min(max(n, 0), s) for n in kv_lens)
    elem = 1 if int8 else 2
    kv_bytes = 2 * live * kv * d * elem + (2 * live * kv * 2 if int8 else 0)
    io_bytes = 2 * b * h * d * 2 + b * 4
    out = {"cache": "int8" if int8 else "bf16", "kv_len": list(kv_lens),
           "heads": list(heads), "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_err": lib_err,
           "bitwise_equal_launches": REPEATS + 2, "second_call": "ok",
           **bound(kv_bytes + io_bytes, 4 * live * h * d)}
    out["bound_share"] = out["bound_ms"] / ms
    return out


# the decode cases of phase 2, the main path's first: (page size, int8)
PAGED_CASES = ((64, False), (64, True), (128, False), (128, True),
               (16, False))
SLOT_CASES = ((False, KV_LENS), (True, KV_LENS), (True, EDGE_LENS),
              (False, EDGE_LENS))
# one rank's heads under tp=2 (phase 15), bf16 and int8
TP_PAGED_CASES = ((64, False), (64, True))
# phase 20's decode: bf16 pages of 64 over an 8,192-position span, streams
# of the ring's prompts (8,160 / 3,000 / 100 tokens plus up to 32 new) and
# the span's edges; each of the 8 partials covers up to 1,024 positions
RING_SPAN = 8192
RING_KV_LENS = (8191, 3031, 99, 8192, 8160, 131, 1, 4097)
RING_OTHER_LENS = (3000, 8192, 0, 100, 6000, 65, 8100, 2049)
TP_SLOT_CASES = ((False, KV_LENS), (True, KV_LENS))


# (name, B, S, H, KV, D): causal, q_offset 0; the first is the main path
FA_SHAPES = (("llama_400m_train", 16, 511, 12, 6, 128),
             # one rank's heads of llama_400m under tp=2 (phase 17a)
             ("llama_400m_train_tp2", 16, 511, 6, 3, 128),
             ("llama3_8b_heads", 2, 2048, 32, 8, 128),
             ("llama3_8b_distill", 32, 256, 32, 8, 128))
# forward only: the slot-prefill bucket that serving runs ([8, 2048])
FA_FWD_SHAPES = (("llama3_8b_prefill_b8", 8, 2048, 32, 8, 128),)
# (name, B, S, H, KV, D, Sq, q_offset): the global attention under sp
# (phase 18a's flash case) at sp=2, each rank's S/2 queries at its offset
# over the S keys gathered over sp: the last rank's, then the first's
# (whose later half of the keys no query sees)
FA_SP_SHAPES = (("llama_400m_train_sp2", 1, 8192, 12, 6, 128, 4096, 4096),
                ("llama_400m_train_sp2_rank0", 1, 8192, 12, 6, 128, 4096,
                 0))


def _geometry(shape) -> tuple:
    """(B, Sq, Sk, H, KV, D, q_offset) of a shape of FA_SHAPES or
    FA_SP_SHAPES."""
    _, b, s, h, kv, d, *rest = shape
    sq, off = rest if rest else (s, 0)
    return b, sq, s, h, kv, d, off


def _causal_pairs(sq: int, sk: int, off: int) -> int:
    """Live (query, key) pairs of one head's causal mask: query row i
    sees keys 0 .. off + i, at most all ``sk``."""
    full = max(0, min(sq, sk - off))        # rows short of the last key
    return full * off + full * (full + 1) // 2 + (sq - full) * sk


def fa_check(name: str, got, want, rows: bool = True) -> tuple:
    """(max abs error, worst error as a share of its limit) of a
    flash-attention output against its plain version: FA_RTOL plus
    FA_SCALED_ATOL of max|want|, taken over each row of a head (``rows``,
    for O: under a causal mask an early row, |o| near 4, would otherwise
    set the limit for a late one, |o| near 0.04) or over the tensor (for
    a gradient, whose rows can cancel to 0: dQ of a row that sees only
    its own key). Raises outside the limit or on a non-finite value."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = w.abs().amax(dim=-1, keepdim=True) if rows else w.abs().max()
    tol = FA_SCALED_ATOL * scale + FA_RTOL * w.abs()
    share = float((err / tol.clamp_min(1e-30)).max())
    if share > 1.0 or not bool(torch.isfinite(g).all()):
        raise RuntimeError(f"{name}: {int((err > tol).sum())} elements off "
                           f"(max abs err {float(err.max()):.3e}, worst "
                           f"error {share:.3g} x its limit)")
    return float(err.max()), share


def fa_inputs(shape):
    """q, k, v and dO at one shape, from the seed."""
    import torch
    b, sq, s, h, kv, d, _ = _geometry(shape)
    g = torch.Generator(device="cuda").manual_seed(SEED + s)

    def r(*dims):
        return torch.randn(dims, generator=g, device="cuda").to(torch.bfloat16)

    return r(b, sq, h, d), r(b, s, kv, d), r(b, s, kv, d), r(b, sq, h, d)


def fa_library_mask(shape):
    """SDPA's arguments for the causal mask at ``shape``: ``is_causal``
    where the queries start at key 0 and match the keys in number, else
    the boolean ``[Sq, Sk]`` mask of query rows at ``q_offset``."""
    import torch
    _, sq, s, _, _, _, off = _geometry(shape)
    if sq == s and off == 0:
        return {"is_causal": True}
    rows = off + torch.arange(sq, device="cuda")[:, None]
    return {"attn_mask": rows >= torch.arange(s, device="cuda")[None, :]}


def fa_entry(shape, kern, checked, ms, plain_ms, library_ms) -> dict:
    """One case of kernel ``kern`` (fwd, dkdv or dq) with its bound."""
    label = shape[0]
    b, sq, s, h, kv, d, off = _geometry(shape)
    # live (query, key) pairs of the causal mask
    pairs = b * h * _causal_pairs(sq, s, off)
    q_bytes = b * sq * h * d * 2                    # q, o, dO, dq (bf16)
    kv_bytes = b * s * kv * d * 2                   # k, v, dk, dv (bf16)
    row_bytes = b * h * sq * 4                      # lse, delta (fp32)
    work = {"fwd": (2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * d * pairs),
            "dkdv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
                     8 * d * pairs),
            "dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                   6 * d * pairs)}[kern]
    err, share = checked
    return {"shape": label, "b": b, "s": s, "h": h, "kv": kv, "d": d,
            **({"sq": sq, "q_offset": off} if (sq, off) != (s, 0) else {}),
            "max_abs_err": err, "err_share_of_limit": share, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **bound(*work)}


def flash_attention_fwd_case(shape, flush) -> dict:
    """Kernel 3 vs its plain version at one shape, with its time, its
    bound and its share of it, and SDPA's forward as the library
    yardstick, timed here only and never called by the port."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    label, off = shape[0], _geometry(shape)[-1]
    q, k, v, _ = fa_inputs(shape)
    o, lse = fa.flash_attention_fwd(q, k, v, q_offset=off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    checked = fa_check(f"flash_attention_fwd {label}", o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    if lse_err > LSE_ATOL:
        raise RuntimeError(f"flash_attention_fwd {label}: lse off by "
                           f"{lse_err:.3e}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    mask = fa_library_mask(shape)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **mask)

    lib_err = float((library().transpose(1, 2).float()
                     - o_ref.float()).abs().max())
    iters = 20
    out = fa_entry(
        shape, "fwd", checked,
        timed_ms(lambda: fa.flash_attention_fwd(q, k, v, q_offset=off),
                 iters, flush),
        timed_ms(lambda: fa.flash_attention_reference(q, k, v, q_offset=off),
                 3, flush),
        timed_ms(library, iters, flush))
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["lse_max_abs_err"] = lse_err
    out["library_max_abs_err"] = lib_err
    return out


def flash_attention_bwd_case(shape, flush, dkdv=None, dq=None,
                             plain: bool = True) -> tuple:
    """Kernels 4 and 5 vs their plain versions at one shape, from the
    plain forward's lse, with their times, bounds and shares of them;
    SDPA's backward (dQ, dK and dV together, its rowsum pass included) as
    the library yardstick of both, and beside it the port's whole
    backward (``attention_delta`` and both kernels, as ``_FlashAttention``
    runs it). ``dkdv``/``dq`` default to the wrappers; another launcher of
    the same signature (a variant's source) can stand in, and ``plain``
    False skips timing the plain versions."""
    import torch
    import torch.nn.functional as F
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    label, off = shape[0], _geometry(shape)[-1]
    # the offset goes only where it is not 0: a variant's launcher may
    # take none
    at = {"q_offset": off} if off else {}
    kernel_dkdv = dkdv or fa.flash_attention_bwd_dkdv
    kernel_dq = dq or fa.flash_attention_bwd_dq

    def run_dkdv(*a):
        return kernel_dkdv(*a, **at)

    def run_dq(*a):
        return kernel_dq(*a, **at)

    q, k, v, do = fa_inputs(shape)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, q_offset=off)
    delta = fa.attention_delta(o_ref, do)
    bwd_in = (q, k, v, do, lse_ref, delta)
    dk, dv = run_dkdv(*bwd_in)
    dq_out = run_dq(*bwd_in)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkdv_reference(*bwd_in,
                                                           q_offset=off)
    dq_ref = fa.flash_attention_bwd_dq_reference(*bwd_in, q_offset=off)
    torch.cuda.synchronize()
    checked_dkdv = max(
        fa_check(f"flash_attention_bwd_dkdv {label} dk", dk, dk_ref,
                 rows=False),
        fa_check(f"flash_attention_bwd_dkdv {label} dv", dv, dv_ref,
                 rows=False))
    checked_dq = fa_check(f"flash_attention_bwd_dq {label}", dq_out, dq_ref,
                          rows=False)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **fa_library_mask(shape))
    do_t = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, leaves, do_t, retain_graph=True)

    def port_backward():
        d = fa.attention_delta(o_ref, do)
        return run_dkdv(q, k, v, do, lse_ref, d), run_dq(q, k, v, do,
                                                          lse_ref, d)

    iters = 20
    lib_ms = timed_ms(library, iters, flush)
    whole_ms = timed_ms(port_backward, iters, flush)
    dkdv_entry = fa_entry(
        shape, "dkdv", checked_dkdv,
        timed_ms(lambda: run_dkdv(*bwd_in), iters, flush),
        timed_ms(lambda: fa.flash_attention_bwd_dkdv_reference(
            *bwd_in, q_offset=off), 5, flush) if plain else None, lib_ms)
    dq_entry = fa_entry(
        shape, "dq", checked_dq,
        timed_ms(lambda: run_dq(*bwd_in), iters, flush),
        timed_ms(lambda: fa.flash_attention_bwd_dq_reference(
            *bwd_in, q_offset=off), 5, flush) if plain else None, lib_ms)
    for entry in (dkdv_entry, dq_entry):
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["port_backward_ms"] = whole_ms
    return dkdv_entry, dq_entry


def phase_kernels(flush):
    cases = [flash_decode_case(ps, int8, flush) for ps, int8 in PAGED_CASES]
    cases += [flash_decode_case(ps, int8, flush, heads=HEADS_TP2)
              for ps, int8 in TP_PAGED_CASES]
    cases.append(flash_decode_case(64, False, flush, span=RING_SPAN,
                                   lens=RING_KV_LENS,
                                   other_lens=RING_OTHER_LENS))
    for c in cases:
        log(f"[kernel] flash_decode_paged {json.dumps(c)}")
    slot_cases = [slot_decode_case(int8, lens, flush)
                  for int8, lens in SLOT_CASES]
    slot_cases += [slot_decode_case(int8, lens, flush, heads=HEADS_TP2)
                   for int8, lens in TP_SLOT_CASES]
    for c in slot_cases:
        log(f"[kernel] flash_decode {json.dumps(c)}")
    fa_cases = {"fwd": [flash_attention_fwd_case(shape, flush)
                        for shape in FA_SHAPES + FA_FWD_SHAPES
                        + FA_SP_SHAPES],
                "dkdv": [], "dq": []}
    for shape in FA_SHAPES + FA_SP_SHAPES:
        dkdv, dq = flash_attention_bwd_case(shape, flush)
        fa_cases["dkdv"].append(dkdv)
        fa_cases["dq"].append(dq)
    for kern, kern_cases in fa_cases.items():
        for c in kern_cases:
            log(f"[kernel] flash_attention_{kern} {json.dumps(c)}")
    return cases, slot_cases, fa_cases


# --------------------------------------------------------------- phase 3


def _prompt(rng, n, vocab):
    return [int(t) for t in rng.integers(0, vocab, n)]


def serve_queue(v: int) -> list:
    """Phase 3's 12 requests from the seed: 64-1,500 prompt tokens, 32
    new; two share a 319-token prefix: 4 full radix pages of 64 (the
    lookup hit) plus 63 tokens of the fifth (the boundary COW)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    base = _prompt(rng, 320, v)
    alt = (base[319] + 1) % v
    lens = (64, 1500, 300, 777, 128, 1024, 95, 640, 1200, 411)
    queue = [{"prompt": _prompt(rng, n, v), "max_new": 32,
              "request_id": f"r{i}"} for i, n in enumerate(lens)]
    queue.insert(2, {"prompt": base + _prompt(rng, 380, v), "max_new": 32,
                     "request_id": "prefix-a"})
    queue.append({"prompt": base[:319] + [alt] + _prompt(rng, 200, v),
                  "max_new": 32, "request_id": "prefix-b"})
    return queue


def drain_timed(srv, queue) -> tuple:
    """Phase 3's drive: the first 6 requests at decode window 1, the rest
    at 8, submitting as streams free up. Returns (wall s, {request:
    seconds from its run's start to its first token})."""
    runs = [(queue[:6], 1), (queue[6:], 8)]     # (requests, decode window)
    ttft, t_start = {}, time.perf_counter()
    for reqs, window in runs:
        t_sub = time.perf_counter()
        pending = list(reqs)
        while pending or srv.requests_active():
            placed = srv.submit_many(pending)
            pending = pending[len(placed):]
            srv.step_many(window)
            now = time.perf_counter()
            for r in srv.requests:
                if r is not None and r.tokens and r.request_id not in ttft:
                    ttft[r.request_id] = now - t_sub
            for rid in srv.finished:
                ttft.setdefault(rid, now - t_sub)
    return time.perf_counter() - t_start, ttft


def steady_streams(srv) -> None:
    """Reset ``srv`` and prefill 8 streams (1-1,500 prompt tokens; their
    max_new outlasts the 67 steps the longest takes to prefill), all
    decoding after."""
    import numpy as np
    srv.reset()
    rng = np.random.default_rng(SEED + 1)
    srv.submit_many([{"prompt": _prompt(rng, n, srv.cfg.vocab_size),
                      "max_new": 200, "request_id": i} for i, n in enumerate(
                          (1, 63, 64, 65, 700, 1500, 1300, 333))])
    while srv._prefill_q or srv._pending_first:
        srv.step()
    if len(srv._active()) != 8:
        raise RuntimeError(f"expected 8 decoding streams, got "
                           f"{srv._active()}")


def phase_serve(card: str) -> dict:
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.parallel import aot

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] init 8B params in {time.perf_counter() - t0:.1f} s")
    v = cfg.vocab_size
    queue = serve_queue(v)

    cache = aot.CompileCache()
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, compile_cache=cache,
                              device=dev)
    warm = srv.warmup()
    log(f"[serve] warmup {warm}")
    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode_paged.launches = 0
    wall, ttft = drain_timed(srv, queue)
    launches = fd.flash_decode_paged.launches
    out = srv.finished
    problems = []
    if sorted(out) != sorted(r["request_id"] for r in queue):
        problems.append(f"finished {sorted(out)}")
    short = {k: len(t) for k, t in out.items() if len(t) != 32}
    if short:
        problems.append(f"requests without 32 tokens: {short}")
    if any(not 0 <= t < v for toks in out.values() for t in toks):
        problems.append("token outside the vocabulary")
    if srv.ledger_violations():
        problems.append(f"ledger: {srv.ledger_violations()[:3]}")
    stats = srv.page_stats()
    if stats["prefix_hits"] < 1:
        problems.append(f"no prefix hit: {stats}")
    if launches < 1:
        problems.append("flash_decode_paged never launched on the main path")
    if problems:
        raise RuntimeError("serving phase: " + "; ".join(problems))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(t) for t in out.values())
    run_graphs = _graph_line(srv)
    log(f"[serve] {len(out)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"{launches} kernel launches, stats {stats}, graphs {run_graphs}")

    # one step, kernel vs dense gather, on the live pool of 8 prefilled
    # streams, then the graphed windows against the eager loop, twice:
    # each round after a reset, the second replaying the first's graphs
    steady = []
    for round_ in range(2):
        steady_streams(srv)
        active = srv._active()
        if round_ == 0:
            mp = srv._window_mp(active, 1)
            tbl = torch.tensor(srv._decode_tables()[:, :mp], device=dev)
            logits = {}
            for mode in ("flash", "dense"):
                pool = {side: p.clone() for side, p in srv.pool.items()}
                logits[mode], _ = llama.decode_step_paged(
                    dataclasses.replace(cfg, decode_attn=mode), params,
                    pool, tbl, srv.lengths, srv.cur_tok, rope=srv._rope)
                del pool
            diff, decided = _kernel_vs_dense(logits["flash"],
                                             logits["dense"])
        steady.append(_graph_vs_eager(srv))
    steady = {"after_reset": steady[0], "after_reset_replayed": steady[1],
              "graph_step_ms": steady[1]["graph_step_ms"],
              "eager_step_ms": steady[1]["eager_step_ms"]}
    # a second engine of the same key: a namespace hit, its own captures
    second = serving.PagedServer(cfg, params, slots=8, page_size=64,
                                 prefill_chunk=64, compile_cache=cache,
                                 device=dev)
    second_warm = second.warmup()
    second_line = {"warmup_s": second_warm, "cache": cache.stats(),
                   "shares_rope": second._rope is srv._rope,
                   "graphs": _graph_line(second)}
    # after the workspace grew: the width-1 window graph that warmup()
    # captured with the smallest workspace replays on a short stream and
    # gives the tokens of the second engine, whose graph never saw a
    # growth
    srv.reset()
    short = [{"prompt": _prompt(np.random.default_rng(SEED + 5), 5, v),
              "max_new": 16, "request_id": "short"}]
    got, want = (e.drain([dict(r) for r in short], decode_window=1)
                 for e in (srv, second))
    if got != want:
        raise RuntimeError(f"width-1 window after the workspace grew: "
                           f"{got} vs a fresh engine's {want}")
    del second
    log(f"[serve] steady B=8 {steady}, second engine {second_line}")
    ttfts = sorted(ttft.values())
    return {"serving": {
        "model": "llama3_8b", "max_seq": cfg.max_seq, "layers": cfg.n_layers,
        "dtype": "bf16", "slots": 8, "page_size": 64, "prefill_chunk": 64,
        "requests": len(out), "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "decode_tok_s_b8": 8 / steady["graph_step_ms"] * 1e3,
        "decode_step_ms_b8": steady["graph_step_ms"],
        "steady_b8_window8": steady, "warmup_s": warm,
        "graphs_after_requests": run_graphs, "graphs": _graph_line(srv),
        "second_engine": second_line,
        "peak_mem_gb": peak_gb, "page_stats": stats,
        "flash_vs_dense_max_abs_logit": diff,
        "flash_vs_dense_argmax_decided": int(decided.sum()),
        "card": card}}, launches, params, {"queue": queue, "out": dict(out),
                                           "ttft": ttft}


# windows of 8 steps timed each way from one snapshot of 8 live streams
STEADY_WINDOWS, STEADY_K = 6, 8


def _graph_line(srv) -> dict:
    g = srv.graph_stats()
    return {"graphs": g["graphs"], "capture_s": g["capture_s"],
            "pool_mb": g["pool_bytes"] / 2 ** 20,
            "keys": [list(k) if isinstance(k, tuple) else k
                     for k in g["keys"]]}


def _kv_of(srv):
    return srv.pool if hasattr(srv, "pool") else srv.cache


def eager_loop(srv, k: int):
    """The eager model-function loop driven by hand, from a snapshot of a
    live engine ``srv``: the engines' decode path before CUDA graphs (the
    mask and the paged table built per window, ``decode_step_paged`` /
    ``decode_step_slots`` plus greedy select per step, one host transfer
    a window), on clones of its K/V, lengths and tokens. Returns
    ``(window, state)``: each ``window()`` decodes ``k`` steps of the
    streams active at the snapshot and returns their tokens on the host
    [k, slots]; ``state`` holds the clones (``kv``, ``ln``, ``tok``)."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops.quant import QTensor

    paged = isinstance(srv, serving.PagedServer)
    dev = srv.device
    kv = {s: (QTensor(x.q.clone(), x.s.clone()) if isinstance(x, QTensor)
              else x.clone()) for s, x in _kv_of(srv).items()}
    active = srv._active()
    tables = srv._decode_tables() if paged else None
    # the host mirror of the longest stream, as the engine keeps it
    state = {"kv": kv, "ln": srv.lengths.clone(), "tok": srv.cur_tok.clone(),
             "top": max(srv.requests[i].prompt_len
                        + len(srv.requests[i].tokens) for i in active)}

    def window():
        ln, tok = state["ln"], state["tok"]
        mask = torch.zeros((srv.slots,), dtype=torch.bool, device=dev)
        mask[active] = True
        if paged:
            mp = min(srv.pages_per_stream,
                     (state["top"] + k - 2) // srv.page_size + 1)
            tbl = torch.tensor(tables[:, :mp], device=dev)
        out = []
        for _ in range(k):
            if paged:
                logits, _ = llama.decode_step_paged(
                    srv.cfg, srv.params, kv, tbl, ln, tok, rope=srv._rope,
                    ffn_override=srv._ffn)
            else:
                logits, _ = llama.decode_step_slots(
                    srv.cfg, srv.params, kv, ln, tok, rope=srv._rope)
            nxt = torch.where(mask, torch.argmax(logits, dim=-1).to(
                torch.int32), tok)
            ln = torch.where(mask, ln + 1, ln)
            tok = nxt
            out.append(nxt)
        state.update(ln=ln, tok=tok, top=state["top"] + k)
        return torch.stack(out).cpu().numpy()

    return window, state


def _graph_vs_eager(srv, windows=STEADY_WINDOWS, k=STEADY_K) -> dict:
    """From one snapshot of a live engine (8 decoding streams): ``windows``
    windows of ``k`` steps through :func:`eager_loop`, then through
    ``step_many(k)``, which replays the engine's graphs (a width not seen
    yet is captured on the way). Each window is timed unprofiled on the
    host clock through its host transfer; the step time is the median
    window's over ``k``; ``graph_launches`` counts the kernels that the
    graphed windows alone launched. Raises unless both give the same
    tokens and lengths and write bitwise the same K/V."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.ops.quant import QTensor

    active = srv._active()
    window, state = eager_loop(srv, k)
    eager_ms, eager = [], []
    torch.cuda.synchronize()
    for _ in range(windows):
        t0 = time.perf_counter()
        eager.append(window())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    kv, ln, tok = state["kv"], state["ln"], state["tok"]
    captured_before = len(srv._graphs)
    launched_before = _launch_counts()
    graph_ms, graphed = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = srv.step_many(k)
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        graphed.append(out)
    graph_launches = {name: n - launched_before[name]
                      for name, n in _launch_counts().items()}
    want = np.concatenate(eager)
    problems = []
    for i in active:
        got = [t for out in graphed for t in out[i]]
        if got != want[:, i].tolist():
            problems.append(f"stream {i}: graphed {got[:8]}... vs eager "
                            f"{want[:, i].tolist()[:8]}...")
    if not (torch.equal(srv.lengths, ln) and torch.equal(srv.cur_tok, tok)):
        problems.append(f"lengths {srv.lengths.tolist()} vs eager "
                        f"{ln.tolist()}")
    bitwise, max_diff = True, 0.0
    for side in ("k", "v"):
        a, b = _kv_of(srv)[side], kv[side]
        pairs = [(a.q, b.q), (a.s, b.s)] if isinstance(a, QTensor) \
            else [(a, b)]
        for x, y in pairs:
            if not torch.equal(x, y):
                bitwise = False
                max_diff = max(max_diff, float((x.float() - y.float())
                                               .abs().max()))
    del kv
    if not bitwise:
        problems.append(f"K/V written differ, max abs {max_diff}")
    if problems:
        raise RuntimeError("graphed windows vs the eager loop: "
                           + "; ".join(problems[:4]))
    med = sorted(graph_ms)[len(graph_ms) // 2]
    med_eager = sorted(eager_ms)[len(eager_ms) // 2]
    return {"batch": len(active), "windows": windows, "k": k,
            "graph_step_ms": med / k, "eager_step_ms": med_eager / k,
            "graph_window_ms": graph_ms, "eager_window_ms": eager_ms,
            "speedup": med_eager / med,
            "graphs_captured_here": len(srv._graphs) - captured_before,
            "graph_launches": graph_launches,
            "tokens_equal": True, "kv_bitwise_equal": bitwise,
            "kv_max_abs_diff": max_diff}


def _kernel_vs_dense(lf, ld, atol=LOGIT_ATOL):
    """Max |logit difference| of a decode step through the kernel vs the
    dense read, and how many rows have a decided argmax (top two apart by
    more than the tolerance); raises if they disagree."""
    import torch
    diff = float((lf - ld).abs().max())
    top2 = torch.topk(ld, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > atol
    agree = (lf.argmax(-1) == ld.argmax(-1)) | ~decided
    if diff > atol or not bool(agree.all()) \
            or not bool(torch.isfinite(lf).all()):
        raise RuntimeError(f"decode step kernel vs dense: max |dlogit| "
                           f"{diff:.4f} (tol {atol}), argmax agree "
                           f"{agree.tolist()}")
    return diff, decided


# --------------------------------------------------------------- phase 5

SLOT_LENS = (64, 1500, 300, 777, 128, 1024, 95, 640, 1200, 411, 256, 900)
STREAMED = (1, 6)          # request indices sent with "stream": true


def _http_generate(port: int, body: dict) -> dict:
    """One ``POST /v1/generate``; a streamed reply is read line by line
    and folded into the unary reply's shape."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            return json.loads(r.read())
        lines = [json.loads(raw) for raw in r]
    done = lines[-1]
    if not done.get("done") or "error" in done:
        raise RuntimeError(f"stream ended badly: {done}")
    return {"tokens": [e["token"] for e in lines if "token" in e], **done}


def _http_get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def phase_serve_slots(card: str, params):
    """The worker's default engine: Llama-3-8B (max_seq 2048) in
    ``SlotServer(slots=8)`` behind ``ServingFrontend``."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.models.ingress import ServingFrontend
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    v = cfg.vocab_size
    rng = np.random.default_rng(SEED + 2)
    bodies = [{"prompt": _prompt(rng, n, v), "max_new": 32,
               "stream": i in STREAMED} for i, n in enumerate(SLOT_LENS)]
    solo_prompt = _prompt(rng, 256, v)
    srv = serving.SlotServer(cfg, params, slots=8, device=dev)
    fe = ServingFrontend(srv, port=0, host="127.0.0.1", decode_window=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode.launches = 0
    fa.flash_attention_fwd.launches = 0
    fe.start()
    try:
        replies = [None] * len(bodies)
        errors = []

        def hit(i):
            try:
                replies[i] = _http_generate(fe.port, bodies[i])
            except Exception as e:          # reported below, all at once
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        health = _http_get(fe.port, "/v1/healthz")
        stats = _http_get(fe.port, "/v1/stats")
    finally:
        fe.stop()
    solo = llama.generate_chunked(
        cfg, params, torch.tensor([solo_prompt], dtype=torch.int32,
                                  device=dev), 32, chunk=16)
    torch.cuda.synchronize()
    launches = {"flash_decode": fd.flash_decode.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    problems = list(errors)
    if any(t.is_alive() for t in threads):
        problems.append("a request thread did not finish")
    for i, r in enumerate(replies):
        toks = (r or {}).get("tokens", [])
        if len(toks) != 32 or not all(0 <= t < v for t in toks):
            problems.append(f"request {i}: {len(toks)} tokens, in vocab "
                            f"{all(0 <= t < v for t in toks)}")
    if stats["requests"] != len(bodies) or stats["tokens"] != 32 * len(
            bodies):
        problems.append(f"/v1/stats counts {stats['requests']} requests, "
                        f"{stats['tokens']} tokens")
    if not health["ok"] or health["free"] != 8:
        problems.append(f"/v1/healthz {health}")
    if tuple(solo.shape) != (1, 32) or not bool(
            ((solo >= 0) & (solo < v)).all()):
        problems.append(f"solo generate_chunked gave {tuple(solo.shape)}")
    for name, n in launches.items():
        if n < 1:
            problems.append(f"{name} never launched on the main path")
    if problems:
        raise RuntimeError("slot serving phase: " + "; ".join(problems))
    n_tok = sum(len(r["tokens"]) for r in replies)
    log(f"[slots] {len(replies)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"launches {launches}, stats {stats}")

    # after a reset (the front door's window graph stays captured): one
    # step through the kernel vs the dense read on a live cache of 8
    # slots, then the graphed windows against the eager loop
    srv.reset()
    rng = np.random.default_rng(SEED + 3)
    srv.submit_many([{"prompt": _prompt(rng, n, v), "max_new": 200,
                      "request_id": i} for i, n in enumerate(
                          (1, 63, 64, 65, 700, 1500, 1300, 333))])
    srv.step()
    if len(srv.free_slots()) != 0:
        raise RuntimeError(f"expected 8 live slots, free {srv.free_slots()}")
    logits = {}
    for mode in ("flash", "dense"):
        cache = {side: c.clone() for side, c in srv.cache.items()}
        logits[mode], _ = llama.decode_step_slots(
            dataclasses.replace(cfg, decode_attn=mode), params, cache,
            srv.lengths, srv.cur_tok, rope=srv._rope)
        del cache
    diff, decided = _kernel_vs_dense(logits["flash"], logits["dense"])
    steady = _graph_vs_eager(srv)
    log(f"[slots] steady B=8 {steady}")
    return {"serving_slots": {
        "model": "llama3_8b", "max_seq": cfg.max_seq, "layers": cfg.n_layers,
        "dtype": "bf16", "engine": "SlotServer", "slots": 8,
        "front_door": "ServingFrontend", "decode_window": 8,
        "requests": len(replies), "streamed": len(STREAMED),
        "tokens_out": n_tok, "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "decode_tok_s_b8": 8 / steady["graph_step_ms"] * 1e3,
        "decode_step_ms_b8": steady["graph_step_ms"],
        "steady_b8_window8": steady, "graphs": _graph_line(srv),
        "peak_mem_gb": peak_gb, "launches": launches,
        "solo_generate_chunked": {"batch": 1, "chunk": 16, "steps": 32},
        "flash_vs_dense_max_abs_logit": diff,
        "flash_vs_dense_argmax_decided": int(decided.sum()),
        "card": card}}, launches


# --------------------------------------------------------------- phase 6

WORKER_LENS = (64, 1500, 300, 777, 128, 1024, 95, 640)
WORKER_STREAMED = (3,)
WORKER_ARGS = ("llama", "--preset", "8b", "--serve", "--slots", "8",
               "--serve-port", "0", "--serve-interval", "2")
# the worker's engines: (line name, extra flags, engine, the kernels its
# run must launch)
WORKER_ENGINES = (
    ("worker", (), "SlotServer", ("flash_decode", "flash_attention_fwd")),
    ("worker_paged", ("--pages", "64"), "PagedServer",
     ("flash_decode_paged",)),
)
WORKER_BOOT_S = 600
WORKER_VOCAB = 128256           # Llama-3-8B's
WORKER_MODULE = ("-m", "dcos_commons_tpu_torch.frameworks.worker")


def _event_reader(proc, events: list, forbid, who: str):
    """Pump ``proc``'s stdout on a thread and return ``event(name,
    timeout, where=...)``: the next JSON event of that name passing
    ``where`` (every event read lands in ``events``); an ``error`` event
    or one in ``forbid`` raises, as does the deadline or the process
    ending first."""
    import queue
    lines: "queue.Queue[str]" = queue.Queue()

    def pump():
        for raw in proc.stdout:
            lines.put(raw)

    threading.Thread(target=pump, daemon=True).start()

    def event(name, timeout, where=lambda e: True):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            try:
                raw = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None and lines.empty():
                    break
                continue
            if raw.startswith("{"):
                e = json.loads(raw)
                events.append(e)
                if e.get("event") == "error" or e.get("event") in forbid:
                    raise RuntimeError(f"{who}: {e}")
                if e.get("event") == name and where(e):
                    return e
        raise RuntimeError(f"{who}: no {name} event within {timeout} s "
                           f"(exit {proc.poll()})")

    return event


def _sigterm(proc) -> int:
    """End a worker as the scheduler does (SIGTERM, then a kill after 60
    s); its exit code."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def phase_worker(card: str, name: str, extra, engine: str, kernels,
                 expect=(), forbid=("paged_fallback",), rounds=None,
                 ready=None, env=None, cwd=None, worker_args=WORKER_ARGS,
                 launch=WORKER_MODULE):
    """The process the scheduler starts: the port's worker
    (``python -m dcos_commons_tpu_torch.frameworks.worker`` with
    ``WORKER_ARGS`` and ``extra``, serving with ``engine``) on the card.
    Reads its ``serving`` event (after each event of ``expect``; an event
    of ``forbid`` or an ``error`` fails the phase), sends 8 concurrent
    ``POST /v1/generate`` (64-1,500 prompt tokens, 32 new, one streamed),
    checks ``/v1/healthz`` and ``/v1/stats``, waits for a heartbeat that
    has seen them, and ends it with SIGTERM. Its kernel launches are the
    worker's own counts while it served: the heartbeat's less those in
    its ``serving`` event. ``rounds`` (lists of request bodies) replaces
    the 8 requests: each round's requests are sent at once, round after
    round, and the replies come back in that order. ``ready`` (no
    arguments) runs after the ``serving`` event, before the first
    request. ``env`` adds to the worker's environment, ``cwd`` replaces
    its working directory, ``worker_args`` the flags before ``extra``
    (with ``--device cpu`` there, no kernel launch is required),
    ``launch`` the interpreter arguments that start the worker. Returns
    (line, launches, replies, events)."""
    import signal

    root = Path(__file__).resolve().parent
    cwd = cwd or root / "build" / "worker_smoke"
    cwd.mkdir(parents=True, exist_ok=True)
    args = [*worker_args, *extra]
    on_card = not ("--device" in args
                   and args[args.index("--device") + 1] == "cpu")
    cmd = [sys.executable, *launch, *args]
    env = dict(os.environ, PYTHONPATH=str(root), **(env or {}))
    v = WORKER_VOCAB
    rounds = rounds or [worker_bodies()]
    bodies = [b for r in rounds for b in r]
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            text=True)
    events = []
    event = _event_reader(proc, events, forbid, "worker")
    try:
        for name_ in expect:
            event(name_, WORKER_BOOT_S)
        serving = event("serving", WORKER_BOOT_S)
        boot_s = time.perf_counter() - t_start
        if ready is not None:
            ready()
        port = serving["port"]
        replies, errors = [None] * len(bodies), []

        def hit(i):
            try:
                replies[i] = _http_generate(port, bodies[i])
            except Exception as e:          # reported below, all at once
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads, first = [], 0
        for r in rounds:
            batch = [threading.Thread(target=hit, args=(first + i,))
                     for i in range(len(r))]
            first += len(r)
            for t in batch:
                t.start()
            for t in batch:
                t.join(timeout=600)
            threads += batch
        wall = time.perf_counter() - t0
        health = _http_get(port, "/v1/healthz")
        stats = _http_get(port, "/v1/stats")
        beat = event("heartbeat", 60,
                     lambda e: e.get("requests", 0) >= len(bodies))
    finally:
        rc = _sigterm(proc)
    problems = list(errors)
    if any(t.is_alive() for t in threads):
        problems.append("a request thread did not finish")
    for i, r in enumerate(replies):
        toks = (r or {}).get("tokens", [])
        if len(toks) != 32 or not all(0 <= t < v for t in toks):
            problems.append(f"request {i}: {len(toks)} tokens")
    if stats["requests"] != len(bodies) or stats["tokens"] != 32 * len(
            bodies):
        problems.append(f"/v1/stats counts {stats['requests']} requests, "
                        f"{stats['tokens']} tokens")
    if not health["ok"] or health["free"] != 8:
        problems.append(f"/v1/healthz {health}")
    at_serving = serving.get("launches", {})
    launches = {k: beat.get("launches", {}).get(k, 0) - at_serving.get(k, 0)
                for k in kernels}
    for k, n in launches.items():
        if n < 1 and on_card:
            problems.append(f"{k} never launched while the worker served")
    if ("paged" in serving) != (engine == "PagedServer"):
        problems.append(f"the worker served another engine: {serving}")
    if rc != -signal.SIGTERM:
        problems.append(f"worker exited {rc} on SIGTERM")
    if problems:
        raise RuntimeError(f"{name} phase: " + "; ".join(problems))
    n_tok = sum(len(r["tokens"]) for r in replies)
    line = {name: {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(args),
        "model": "llama3_8b", "max_seq": 2048, "dtype": "bf16",
        "engine": engine, "slots": 8, "decode_window": 8,
        "boot_to_serving_s": boot_s, "cold_start": serving["cold_start"],
        "solo_tokens_per_sec": serving["tokens_per_sec"],
        "requests": len(replies),
        "streamed": sum(bool(b.get("stream")) for b in bodies),
        "prompt_lens": [len(b["prompt"]) for b in bodies],
        "tokens_out": n_tok,
        "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "peak_mem_gb": beat.get("peak_mem_gb"), "graphs": beat.get("graphs"),
        "launches": launches, "exit_on_sigterm": rc,
        "stats_window": stats["window"],
        **({"paged": beat["paged"]} if "paged" in beat else {}),
        "card": card}}
    log(f"[{name}] {line}")
    return line, launches, [r["tokens"] for r in replies], events


def worker_bodies():
    """The workers' 8 requests, from the seed."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    return [{"prompt": _prompt(rng, n, WORKER_VOCAB), "max_new": 32,
             "stream": i in WORKER_STREAMED}
            for i, n in enumerate(WORKER_LENS)]


# --------------------------------------------------------------- phase 7

# the worker's DRAFT_LAYERS / DRAFT_K defaults
DRAFT_LAYERS, SPEC_K = 1, 4
# requests of phase 3 the self-draft serves (the last one after the
# others, adopting prefix-a's radix pages), and its eager windows whose
# rejections are held to the near-tie rule
SELF_DRAFT_REQUESTS = ("r0", "r1", "prefix-a", "prefix-b")
SELF_DRAFT_WINDOWS = 8
# the least share of self-draft proposals each served drain must accept:
# a sound self-draft accepted 96 of 108 on the H100 (it rejects only at
# bf16 near-ties, each costing up to k-1 proposals of a one-stream
# drain's few dozen), a draft that sees the wrong cache about none
SELF_DRAFT_ACCEPT_FLOOR = 0.5
# a spec stream may leave the solo stream only where the solo's logit of
# the spec's token is within this of its top logit (the verify reads the
# dense gather, solo decode kernel 1, in another reduction order): the
# kernel-vs-dense tolerance of one decode step
NEAR_TIE_ATOL = LOGIT_ATOL


def _teacher_gaps(cfg, params, rope, prompt, toks, ffn=None) -> list:
    """For each token of ``toks``, the target's top logit less its logit
    of that token at its position: one causal forward over ``prompt +
    toks[:-1]`` (the stream fed back as its own prefix). With ``ffn`` (an
    MoE model's ``make_moe_ffn``) the forward is one ``extend_step`` from
    position 0, the sequence one dispatch group."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.quant import qmm
    dev = rope.device
    seq = torch.tensor([prompt + toks[:-1]], dtype=torch.int32, device=dev)
    if ffn is None:
        x, _, _ = llama.prefill_trunk(cfg, params, seq, rope)
        logits = qmm(x[0, len(prompt) - 1:], params["lm_head"]).float()
    else:
        cache = llama.init_kv_cache(cfg, 1, cfg.max_seq, device=dev)
        logits, _ = llama.extend_step(cfg, params, cache, seq, 0, rope=rope,
                                      ffn_override=ffn)
        logits = logits[0, len(prompt) - 1:]
        del cache
    t = torch.tensor(toks, dtype=torch.int64, device=dev)[:, None]
    gaps = logits.max(dim=-1).values - logits.gather(1, t)[:, 0]
    return gaps.tolist()


def stream_check(name, got, want, prompts, cfg, params, ffn=None) -> list:
    """Each stream of ``got`` teacher-forced through the target: every
    token must be within ``NEAR_TIE_ATOL`` of the top logit at its
    position, given the stream's own earlier tokens, so a stream may
    leave the solo ``want`` only at a near-tie and is held to the target
    after it too. Returns where each stream first leaves solo (with the
    gap there); raises on any token away from a near-tie."""
    from dcos_commons_tpu_torch.ops.rotary import rope_frequencies
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=params["norm"].device)
    divergences, problems, checked, worst = [], [], 0, 0.0
    for rid, w in want.items():
        g = got.get(rid)
        if g is None or len(g) != len(w):
            problems.append(f"{rid}: {None if g is None else len(g)} tokens "
                            f"against {len(w)}")
            continue
        gaps = _teacher_gaps(cfg, params, rope, prompts[rid], g, ffn)
        checked, worst = checked + len(g), max(worst, *gaps)
        problems += [f"{rid}: token {j} is {g[j]}, the target's top logit "
                     f"{gap:.4f} above it" for j, gap in enumerate(gaps)
                     if gap > NEAR_TIE_ATOL]
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            divergences.append({"stream": rid, "at": j, "gap": gaps[j]})
    if problems:
        raise RuntimeError(f"{name}: {len(problems)} tokens away from a "
                           "near-tie of the target: " + "; ".join(
                               problems[:4]))
    log(f"[check] {name}: {checked} tokens teacher-forced, largest gap "
        f"{worst}")
    return divergences


def spec_eager_loop(srv):
    """The speculative window's eager model-function loop driven by hand,
    from a snapshot of an armed ``PagedServer`` ``srv`` with every
    decoding stream active: k greedy ``decode_step_slots`` over the draft
    cache, ``verify_step_paged`` over the pool (the table built per
    window), the acceptance counted on the host, on clones of the pool,
    the draft cache, the lengths and the tokens. Returns ``(window,
    state)``: each ``window()`` returns the window's target tokens
    [slots, k] and ``n_emit`` [slots] on the host."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def clone(kv):
        return {s: (QTensor(x.q.clone(), x.s.clone())
                    if isinstance(x, QTensor) else x.clone())
                for s, x in kv.items()}

    dev = srv.device
    cfg_d, params_d = srv._draft
    k = srv.draft_k
    active = srv._active()
    tables = srv._decode_tables()
    mask = torch.zeros((srv.slots,), dtype=torch.bool, device=dev)
    mask[active] = True
    state = {"pool": clone(srv.pool), "draft": clone(srv._draft_cache),
             "ln": srv.lengths.clone(), "tok": srv.cur_tok.clone()}

    def window():
        ln, tok = state["ln"], state["tok"]
        top = int(ln[active].max()) + 1
        mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
        tbl = torch.tensor(tables[:, :mp], device=dev)
        cur, drafted = tok, []
        for j in range(k):
            lg, _ = llama.decode_step_slots(cfg_d, params_d, state["draft"],
                                            ln + j, cur, rope=srv._draft_rope)
            cur = torch.where(mask, torch.argmax(lg, dim=-1).to(torch.int32),
                              cur)
            drafted.append(cur)
        drafted = torch.stack(drafted[:k - 1], dim=1)
        logits, _ = llama.verify_step_paged(
            srv.cfg, srv.params, state["pool"], tbl, ln,
            torch.cat([tok[:, None], drafted], dim=1), rope=srv._rope)
        state["logits"] = logits
        tgt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        d = state["drafted"] = drafted.cpu().numpy()
        n = np.zeros((srv.slots,), np.int32)
        new_tok = tok.cpu().numpy().copy()
        for i in active:
            a = 0
            while a < k - 1 and d[i, a] == tgt[i, a]:
                a += 1
            n[i] = a + 1
            new_tok[i] = tgt[i, a]
        state["ln"] = ln + torch.from_numpy(n).to(dev)
        state["tok"] = torch.from_numpy(new_tok).to(dev)
        return tgt, n

    return window, state


def verify_vs_steps(srv, atol=LOGIT_ATOL) -> float:
    """The armed engine's K-wide verify (dense gather) against k
    successive paged decode steps through kernel 1, on clones of its
    live pool: the window is the steps' own greedy tokens, and each
    position's logits must agree within ``atol`` (``_kernel_vs_dense``)
    for the active streams. Returns the max |logit difference|."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def clone(kv):
        return {s: (QTensor(x.q.clone(), x.s.clone())
                    if isinstance(x, QTensor) else x.clone())
                for s, x in kv.items()}

    k = srv.draft_k
    active = srv._active()
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    top = int(ln[active].max()) + 1
    mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=srv.device)
    pool = clone(srv.pool)
    steps, window, cur = [], [tok], tok
    for j in range(k):
        lg, _ = llama.decode_step_paged(srv.cfg, srv.params, pool, tbl,
                                        ln + j, cur, rope=srv._rope)
        steps.append(lg)
        cur = torch.argmax(lg, dim=-1).to(torch.int32)
        window.append(cur)
    del pool
    pool = clone(srv.pool)
    verify, _ = llama.verify_step_paged(
        srv.cfg, srv.params, pool, tbl, ln, torch.stack(window[:k], dim=1),
        rope=srv._rope)
    del pool
    worst = 0.0
    for j in range(k):
        diff, _ = _kernel_vs_dense(steps[j][active], verify[active, j],
                                   atol=atol)
        worst = max(worst, diff)
    return worst


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn`` captured as a CUDA graph, over ``iters``
    replays timed with CUDA events."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                            # lazy init
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spec_split(srv) -> dict:
    """A spec window's device time by part, from the armed engine's live
    state (every decoding stream active): the k draft steps, the K-wide
    verify, the verify's page gather and dense attention alone (every
    layer's, at the window's table width) and the acceptance, each
    captured as its own CUDA graph on clones of the state and timed over
    replays (:func:`graph_ms`)."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.attention import gqa_attention

    cfg, k = srv.cfg, srv.draft_k
    cfg_d, params_d = srv._draft
    active = srv._active()
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    mask = torch.zeros((srv.slots,), dtype=torch.bool, device=srv.device)
    mask[active] = True
    top = int(ln[active].max()) + 1
    mp = min(srv.pages_per_stream, (top + k - 2) // srv.page_size + 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=srv.device)
    pool = {s: t.clone() for s, t in srv.pool.items()}
    draft = {s: t.clone() for s, t in srv._draft_cache.items()}
    window = torch.cat([tok[:, None]] * k, dim=1)
    logits = torch.zeros((srv.slots, k, cfg.vocab_size), device=srv.device)

    def draft_steps():
        cur = tok
        for j in range(k):
            lg, _ = llama.decode_step_slots(cfg_d, params_d, draft, ln + j,
                                            cur, rope=srv._draft_rope)
            cur = torch.where(mask, torch.argmax(lg, dim=-1).to(torch.int32),
                              cur)

    def verify():
        llama.verify_step_paged(cfg, srv.params, pool, tbl, ln, window,
                                rope=srv._rope)

    q = torch.randn((srv.slots, k, cfg.n_heads, cfg.head_dim),
                    device=srv.device).to(cfg.dtype)

    def attention():
        for i in range(cfg.n_layers):
            kr = llama._gather_pages(pool["k"][i], tbl, cfg.dtype)
            vr = llama._gather_pages(pool["v"][i], tbl, cfg.dtype)
            gqa_attention(q, kr, vr, causal=True, q_offset=ln,
                          kv_len=ln + k)

    def accept():
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)
        agree = torch.cumprod((window[:, 1:] == tgt[:, :k - 1]).to(
            torch.int32), dim=1)
        n = torch.where(mask, agree.sum(dim=1).to(torch.int32) + 1,
                        torch.zeros_like(ln))
        torch.gather(tgt, 1, (n - 1).clamp(min=0).long()[:, None])

    out = {"draft_steps_ms": graph_ms(draft_steps),
           "verify_ms": graph_ms(verify),
           "verify_gather_attention_ms": graph_ms(attention),
           "accept_ms": graph_ms(accept)}
    out["parts_ms"] = (out["draft_steps_ms"] + out["verify_ms"]
                       + out["accept_ms"])
    out["verify_share"] = out["verify_ms"] / out["parts_ms"]
    return {"k": k, "draft_layers": cfg_d.n_layers, "batch": len(active),
            "table_width": mp, "positions_max": top, **out}


def self_draft_rejections(srv, windows: int) -> list:
    """From a snapshot of an engine armed with the self-draft, ``windows``
    windows of :func:`spec_eager_loop`: for every rejected proposal, the
    verify's top logit less its logit of the proposal. The proposals are
    the target's own greedy tokens reached by another path (kernel 2 over
    the draft cache, against the verify's dense gather), so each gap must
    be within ``NEAR_TIE_ATOL``; raises otherwise."""
    window, state = spec_eager_loop(srv)
    k, out = srv.draft_k, []
    for _ in range(windows):
        _, n = window()
        for i in srv._active():
            a = int(n[i]) - 1
            if a < k - 1:
                row = state["logits"][i, a]
                out.append(float(row.max() - row[int(state["drafted"][i, a])]))
    del state
    bad = [g for g in out if g > NEAR_TIE_ATOL]
    if bad:
        raise RuntimeError(f"self-draft: {len(bad)} of {len(out)} rejections "
                           f"away from a near-tie (verify gaps {bad[:4]})")
    return out


def _live_rows_equal(srv, state) -> tuple:
    """(pool rows equal, draft rows equal): each active stream's rows
    below its length, read through its table in the pool and in place in
    the draft cache, engine against the eager loop's clones, bitwise."""
    import torch
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def parts(x):
        return (x.q, x.s) if isinstance(x, QTensor) else (x,)

    pool_eq = draft_eq = True
    ps = srv.page_size
    for i in srv._active():
        n = int(srv.lengths[i])
        pages = torch.tensor(srv._tables[i, :-(-n // ps)],
                             device=srv.device, dtype=torch.long)
        for side in ("k", "v"):
            for a, b in zip(parts(srv.pool[side]), parts(state["pool"][side])):
                ra = a[:, pages].flatten(1, 2)[:, :n]
                rb = b[:, pages].flatten(1, 2)[:, :n]
                pool_eq &= bool(torch.equal(ra, rb))
            a, b = srv._draft_cache[side], state["draft"][side]
            draft_eq &= bool(torch.equal(a[:, i, :n], b[:, i, :n]))
    return pool_eq, draft_eq


def _spec_graph_vs_eager(srv, windows=STEADY_WINDOWS) -> dict:
    """From one snapshot of an armed engine (8 decoding streams):
    ``windows`` spec windows through :func:`spec_eager_loop`, then through
    ``step_many``, which replays the engine's spec graphs (a width not
    seen yet is captured on the way). Each window is timed unprofiled on
    the host clock through its host transfer. Raises unless both give the
    same tokens, ``n_emit`` and lengths and write bitwise the same live
    K/V rows in the pool and the draft cache."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    active = srv._active()
    k = srv.draft_k
    window, state = spec_eager_loop(srv)
    eager_ms, eager = [], []
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    for _ in range(windows):
        t0 = time.perf_counter()
        eager.append(window())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    graph_ms, graphed, per_window = [], [], []
    for _ in range(windows):
        captured, before = len(srv._graphs), fd.flash_decode.launches
        t0 = time.perf_counter()
        out = srv.step_many(k)
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        graphed.append(out)
        if len(srv._graphs) == captured:            # a replay
            per_window.append(fd.flash_decode.launches - before)
    problems = []
    for w, ((tgt, n), out) in enumerate(zip(eager, graphed)):
        for i in active:
            if out.get(i) != tgt[i, :n[i]].tolist():
                problems.append(f"window {w} stream {i}: graphed {out.get(i)}"
                                f" vs eager {tgt[i, :n[i]].tolist()}")
    if not (torch.equal(srv.lengths, state["ln"])
            and torch.equal(srv.cur_tok, state["tok"])):
        problems.append(f"lengths {srv.lengths.tolist()} vs eager "
                        f"{state['ln'].tolist()}")
    pool_eq, draft_eq = _live_rows_equal(srv, state)
    if not (pool_eq and draft_eq):
        problems.append(f"live K/V rows differ: pool {pool_eq}, draft "
                        f"{draft_eq}")
    want_launches = k * srv._draft[0].n_layers
    if not per_window or any(n != want_launches for n in per_window):
        problems.append(f"kernel 2 launches a replayed window {per_window}, "
                        f"expected {want_launches}")
    del state
    if problems:
        raise RuntimeError("graphed spec windows vs the eager loop: "
                           + "; ".join(problems[:4]))
    emitted = [int(n[i]) for _, n in eager for i in active]
    med = sorted(graph_ms)[len(graph_ms) // 2]
    med_eager = sorted(eager_ms)[len(eager_ms) // 2]
    return {"batch": len(active), "windows": windows, "k": k,
            "graph_window_ms": med, "eager_window_ms": med_eager,
            "graph_window_ms_all": graph_ms, "eager_window_ms_all": eager_ms,
            "tokens_per_target_pass": float(np.mean(emitted)),
            "kernel2_launches_per_window": per_window,
            "tokens_equal": True, "n_emit_equal": True,
            "live_kv_bitwise_equal": True}


def _serve_spec(srv, reqs, window=8):
    """Drain ``reqs`` through the armed engine with the kernel counts set
    to 0 just before and read just after: (streams, wall s, launches,
    captures)."""
    import torch
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    counters = {"flash_decode": fd.flash_decode,
                "flash_decode_paged": fd.flash_decode_paged,
                "flash_attention_fwd": fa.flash_attention_fwd}
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    graphs = len(srv._graphs)
    t0 = time.perf_counter()
    out = srv.drain([dict(r) for r in reqs], decode_window=window)
    wall = time.perf_counter() - t0
    return (out, wall, {n: c.launches for n, c in counters.items()},
            len(srv._graphs) - graphs)


def phase_spec(card: str, params, solo) -> tuple:
    """Speculative decoding in process, on phase 3's 8B weights:
    (1) ``PagedServer(slots=8, page_size=64, prefill_chunk=64)`` armed
    with ``truncate_layers(cfg, params, 1)`` at k=4 serves phase 3's 12
    requests, every stream held to phase 3's solo stream (near-tie rule);
    (3) after a reset, 6 spec windows at B=8 graphed and by the eager
    loop; (2) the self-draft (all 32 layers) on 4 of the requests, then
    its rejections held to the near-tie rule
    (:func:`self_draft_rejections`)."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, serving

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    v = cfg.vocab_size
    queue, want = solo["queue"], solo["out"]
    prompts = {r["request_id"]: r["prompt"] for r in queue}
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, device=dev)
    cfg_d, params_d = llama.truncate_layers(cfg, params, DRAFT_LAYERS)
    t0 = time.perf_counter()
    srv.arm_draft(cfg_d, params_d, k=SPEC_K)
    arm_s = time.perf_counter() - t0
    out, wall, launches, captures = _serve_spec(srv, queue)
    stats = srv.page_stats()
    problems = []
    divergences = stream_check("spec engine (truncated draft)", out, want,
                               prompts, cfg, params)
    if srv.ledger_violations():
        problems.append(f"ledger: {srv.ledger_violations()[:3]}")
    held = sum(srv.radix.held().values()) if srv.radix else 0
    if any(srv._stream_pages) or srv.ledger.in_use() != len(
            srv.radix.held() if srv.radix else ()) or held < 1:
        problems.append(f"pages not back after the drain: {stats}")
    spec = stats["spec"]
    want_k2 = (spec["windows"] + captures) * SPEC_K * DRAFT_LAYERS
    if launches["flash_decode"] != want_k2 or spec["windows"] < 1:
        problems.append(f"kernel 2 launched {launches['flash_decode']} "
                        f"times in {spec['windows']} windows and {captures} "
                        f"captures, expected {want_k2}")
    if launches["flash_attention_fwd"] != len(queue) * DRAFT_LAYERS:
        problems.append(f"kernel 3 launched {launches['flash_attention_fwd']}"
                        f" times for {len(queue)} draft prefills")
    if spec["fallbacks"]:
        problems.append(f"spec fallbacks {spec['fallbacks']}")
    if problems:
        raise RuntimeError("spec phase: " + "; ".join(problems))
    n_tok = sum(len(t) for t in out.values())
    log(f"[spec] {len(out)} requests, {n_tok} tokens in {wall:.1f} s, "
        f"launches {launches}, spec {spec}, divergences {divergences}")

    # (3) graphed vs eager after a reset, replaying part 1's graphs
    srv.reset()
    rng = np.random.default_rng(SEED + 1)
    srv.submit_many([{"prompt": _prompt(rng, n, v), "max_new": 200,
                      "request_id": i} for i, n in enumerate(
                          (1, 63, 64, 65, 700, 1500, 1300, 333))])
    while srv._prefill_q or srv._pending_first:
        srv.step_many(1)
    if len(srv._active()) != 8:
        raise RuntimeError(f"expected 8 decoding streams, got "
                           f"{srv._active()}")
    verify_diff = verify_vs_steps(srv)
    steady = _spec_graph_vs_eager(srv)
    steady["verify_vs_kernel_steps_max_abs_logit"] = verify_diff
    steady["split"] = spec_split(srv)
    log(f"[spec] graphed vs eager {steady}")
    graphs = _graph_line(srv)

    # (2) the self-draft: every layer of the target as its own draft,
    # first on three requests, then on prefix-b alone, whose prompt
    # adopts prefix-a's radix pages (the draft must still see all of it);
    # each drain's acceptance is held to SELF_DRAFT_ACCEPT_FLOOR
    srv.reset()
    cfg_s, params_s = llama.truncate_layers(cfg, params, cfg.n_layers)
    srv.arm_draft(cfg_s, params_s, k=SPEC_K)
    by_id = {r["request_id"]: r for r in queue}
    self_reqs = [by_id[rid] for rid in SELF_DRAFT_REQUESTS]
    out_s, wall_s, launches_s, drains = {}, 0.0, {}, []
    for reqs in (self_reqs[:-1], self_reqs[-1:]):
        before = dict(srv.page_stats())
        out, wall, launches_d, _ = _serve_spec(srv, reqs)
        after = srv.page_stats()
        out_s.update(out)
        wall_s += wall
        for n, c in launches_d.items():
            launches_s[n] = launches_s.get(n, 0) + c
        drains.append({
            "requests": [r["request_id"] for r in reqs],
            "proposed": after["spec"]["proposed"]
            - before["spec"]["proposed"],
            "accepted": after["spec"]["accepted"]
            - before["spec"]["accepted"],
            "prefix_hits": after["prefix_hits"] - before["prefix_hits"]})
    proposed = sum(d["proposed"] for d in drains)
    accepted = sum(d["accepted"] for d in drains)
    self_rate = accepted / max(proposed, 1)
    low = [d for d in drains
           if d["accepted"] < SELF_DRAFT_ACCEPT_FLOOR * d["proposed"]
           or not d["proposed"]]
    if low or drains[-1]["prefix_hits"] < 1:
        raise RuntimeError(f"self-draft: acceptance under "
                           f"{SELF_DRAFT_ACCEPT_FLOOR} or prefix-b adopted "
                           f"no radix page: {drains}")
    div_s = stream_check("spec engine (self-draft)", out_s,
                         {r["request_id"]: want[r["request_id"]]
                          for r in self_reqs}, prompts, cfg, params)
    srv.reset()
    srv.submit_many([{**r, "max_new": 200} for r in self_reqs])
    while srv._prefill_q or srv._pending_first:
        srv.step_many(1)
    gaps = self_draft_rejections(srv, SELF_DRAFT_WINDOWS)
    log(f"[spec] self-draft {len(out_s)} requests in {wall_s:.1f} s, "
        f"accept {self_rate:.3f}, divergences {div_s}, eager rejections' "
        f"verify gaps {gaps}")
    srv.disarm_draft()
    del srv
    return {
        "engine": "PagedServer", "slots": 8, "page_size": 64,
        "prefill_chunk": 64, "k": SPEC_K, "draft_layers": DRAFT_LAYERS,
        "requests": len(out), "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall, "arm_s": arm_s,
        "windows": spec["windows"], "proposed": spec["proposed"],
        "accepted": spec["accepted"], "accept_rate": spec["accept_rate"],
        "fallbacks": spec["fallbacks"],
        "draft_prefill_s": spec["draft_prefill_s"],
        "window_s": spec["window_s"], "captures": captures,
        "launches": launches, "graphs": graphs,
        "near_tie_atol": NEAR_TIE_ATOL, "divergences": divergences,
        "graphed_vs_eager": steady,
        "self_draft": {"requests": len(out_s), "wall_s": wall_s,
                       "proposed": proposed, "accepted": accepted,
                       "accept_rate": self_rate, "launches": launches_s,
                       "accept_floor": SELF_DRAFT_ACCEPT_FLOOR,
                       "drains": drains, "divergences": div_s,
                       "eager_windows": SELF_DRAFT_WINDOWS,
                       "eager_rejections": len(gaps),
                       "eager_rejection_max_gap": max(gaps, default=0.0)},
        "card": card}, launches


def save_spec_draft(params) -> dict:
    """The worker's draft artifact: ``save_draft`` of the 1-layer
    truncated 8B draft under ``build/spec_draft`` (the worker loads it;
    its ``spec_armed`` event says how long that took)."""
    import shutil
    from dcos_commons_tpu_torch.models import llama, speculative

    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    cfg_d, params_d = llama.truncate_layers(cfg, params, DRAFT_LAYERS)
    path = Path(__file__).resolve().parent / "build" / "spec_draft"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    t0 = time.perf_counter()
    step_dir = speculative.save_draft(str(path), 1, cfg_d, params_d,
                                      target_cfg=cfg)
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(step_dir).iterdir())
    return {"path": str(path), "save_s": save_s, "bytes": size}


def phase_spec_worker(card, artifact, solo_replies, params):
    """The worker with ``--spec-decode`` on the artifact: ``spec_armed``
    with one draft layer (a ``spec_fallback`` fails the phase), the
    requests of phase 6, tokens held to the paged worker's solo streams
    (near-tie rule), ``/v1/stats`` with spec windows."""
    from dcos_commons_tpu_torch.models import llama
    extra = ("--pages", "64", "--spec-decode", "true", "--draft-checkpoint",
             artifact["path"], "--draft-k", str(SPEC_K))
    line, launches, replies, events = phase_worker(
        card, "worker_spec", extra, "PagedServer",
        ("flash_decode", "flash_attention_fwd"), expect=("spec_armed",),
        forbid=("paged_fallback", "spec_fallback"))
    armed = next(e for e in events if e["event"] == "spec_armed")
    body = line["worker_spec"]
    problems = []
    if armed["draft_layers"] != DRAFT_LAYERS or armed["k"] != SPEC_K:
        problems.append(f"armed {armed}")
    if not body["stats_window"].get("spec_windows"):
        problems.append(f"/v1/stats shows no spec window: "
                        f"{body['stats_window']}")
    if launches["flash_attention_fwd"] != len(WORKER_LENS) * DRAFT_LAYERS:
        problems.append(f"kernel 3 launched {launches['flash_attention_fwd']}"
                        " times while serving")
    if problems:
        raise RuntimeError("worker_spec phase: " + "; ".join(problems))
    bodies = worker_bodies()
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    divergences = stream_check(
        "worker_spec", dict(enumerate(replies)), dict(enumerate(solo_replies)),
        {i: b["prompt"] for i, b in enumerate(bodies)}, cfg, params)
    body["spec_armed"] = armed
    body["divergences"] = divergences
    return line, launches


# --------------------------------------------------------------- phase 8

# the reference's distill defaults at the 8B preset
DISTILL_BATCH, DISTILL_SEQ, DISTILL_STEPS = 32, 256, 20
DISTILL_ARGS = ("distill", "--preset", "8b", "--draft-layers",
                str(DRAFT_LAYERS), "--batch", str(DISTILL_BATCH), "--seq",
                str(DISTILL_SEQ), "--steps", str(DISTILL_STEPS))
# the reckoning for one step at this shape (PERF.md's distill prediction),
# printed beside the run
DISTILL_STEP_S_PREDICTED = (0.35, 0.5)
DISTILL_PEAK_GB_PREDICTED = 49.0
TRAIN_TIMEOUT_S = 900


def _worker_run(args, cwd, timeout=TRAIN_TIMEOUT_S, on_event=None,
                env=None):
    """``python -m dcos_commons_tpu_torch.frameworks.worker *args`` in
    ``cwd`` (``env`` added to this process's): (exit code, its JSON
    events). ``on_event(proc, event)`` sees each event as it arrives."""
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
         *args], cwd=cwd, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(root), **(env or {})))
    events = []
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        for raw in proc.stdout:
            if raw.startswith("{"):
                events.append(json.loads(raw))
                if on_event is not None:
                    on_event(proc, events[-1])
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, events


def _side_by_side(*chains) -> None:
    """Run independent chains of worker runs (each a function of no
    arguments) at once, one thread each: the worker processes share
    nothing but the card, and most of each run is its process's start.
    The first exception of a chain is raised after every chain ended."""
    errors = []

    def guarded(chain):
        try:
            chain()
        except BaseException as e:       # re-raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(c,)) for c in chains]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _in_background(fn):
    """Start ``fn()`` on a thread of its own and return a function that
    waits for it and returns its result or raises its exception. For a
    run of processes beside phases that keep this process's card work
    on the calling thread."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:       # re-raised on the caller's thread
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]

    return join


def _one(events, name):
    found = [e for e in events if e.get("event") == name]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} {name} events: {events[-3:]}")
    return found[0]


def phase_distill(card: str) -> tuple:
    """The worker's ``distill --preset 8b`` at the reference's defaults
    (batch 32 x 256 tokens, 1 draft layer, 20 steps after the warm-up)
    as a subprocess: exit 0, finite falling losses, kernels 3-5 launched
    once a layer a step by the run's own counts (32 + 1 forward launches
    a step, 1 of each backward kernel: no attention went dense), the
    checkpoint and the sealed draft saved. Returns (line, launches, the
    artifact's directory)."""
    import math
    import shutil

    out = Path(__file__).resolve().parent / "build" / "distill_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    rc, events = _worker_run([*DISTILL_ARGS, "--out", str(out)], out.parent)
    wall = time.perf_counter() - t0
    problems = [] if rc == 0 else [f"exit {rc}"]
    done = _one(events, "done") if rc == 0 else {}
    saved = _one(events, "draft_saved") if rc == 0 else {}
    traj = done.get("loss_trajectory") or []
    if not traj or not all(math.isfinite(x) for x in traj):
        problems.append(f"losses {traj}")
    elif not done["loss_final"] < done["loss_first"]:
        problems.append(f"loss did not fall: {traj}")
    steps = done.get("steps_run", 0) + 1                    # and the warm-up
    launches = done.get("launches", {})
    layers = done.get("teacher_layers", 0) + DRAFT_LAYERS
    want = {"flash_attention_fwd": layers * steps,
            "flash_attention_bwd_dkdv": DRAFT_LAYERS * steps,
            "flash_attention_bwd_dq": DRAFT_LAYERS * steps}
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if problems:
        raise RuntimeError("distill phase: " + "; ".join(problems))
    tokens = DISTILL_BATCH * DISTILL_SEQ
    step_s = tokens / done["tokens_per_sec"]
    # the teacher's forward and the student's forward and backward, 2 and
    # 6 flops a weight a token, against the bf16 peak
    line = {"distill": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(DISTILL_ARGS) + " --out DIR",
        "teacher": "llama3_8b", "draft_layers": done["draft_layers"],
        "batch": DISTILL_BATCH, "seq": DISTILL_SEQ,
        "steps_run": done["steps_run"], "loss_first": done["loss_first"],
        "loss_final": done["loss_final"],
        "loss_trajectory": done["loss_trajectory"],
        "tokens_per_s": done["tokens_per_sec"], "step_s": step_s,
        "step_s_predicted": list(DISTILL_STEP_S_PREDICTED),
        "peak_mem_gb": done["peak_mem_gb"],
        "peak_mem_gb_predicted": DISTILL_PEAK_GB_PREDICTED,
        "checkpoint_save_s": saved["save_s"],
        "artifact_save_s": saved["draft_save_s"],
        "process_wall_s": wall, "launches": launches, "card": card}}
    log(f"[distill] {line}")
    return line, launches, saved["path"]


def phase_distill_serve(card, artifact, solo_replies, params, truncated):
    """The distilled artifact served as phase 7's worker serves the
    truncated one: ``spec_armed`` (a ``spec_fallback`` fails), phase 6's
    8 requests, every served token held to the target under the near-tie
    rule; its acceptance beside the truncated draft's ``truncated``."""
    from dcos_commons_tpu_torch.models import llama
    extra = ("--pages", "64", "--spec-decode", "true", "--draft-checkpoint",
             artifact, "--draft-k", str(SPEC_K))
    line, launches, replies, events = phase_worker(
        card, "worker_distilled", extra, "PagedServer",
        ("flash_decode", "flash_attention_fwd"), expect=("spec_armed",),
        forbid=("paged_fallback", "spec_fallback"),
        cwd=Path(__file__).resolve().parent / "build"
        / "worker_smoke_distilled")
    armed = next(e for e in events if e["event"] == "spec_armed")
    body = line["worker_distilled"]
    if armed["draft_step"] != DISTILL_STEPS:
        raise RuntimeError(f"worker_distilled armed {armed}")
    bodies = worker_bodies()
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    body["divergences"] = stream_check(
        "worker_distilled", dict(enumerate(replies)),
        dict(enumerate(solo_replies)),
        {i: b["prompt"] for i, b in enumerate(bodies)}, cfg, params)
    body["spec_armed"] = armed
    spec = body["paged"]["spec"]
    body["accept_rate_distilled"] = spec["accept_rate"]
    body["accept_rate_truncated"] = truncated
    log(f"[worker_distilled] accepted {spec['accepted']} of "
        f"{spec['proposed']} ({spec['accept_rate']}) against the truncated "
        f"draft's {truncated}")
    return line, launches


# --------------------------------------------------------------- phase 9

LT_FRESH, LT_RESUMED, LT_FLASH = 3, 5, 2
LT_LAYERS = 4                   # LlamaConfig.tiny


def _saved_counts(out: Path, step: int) -> tuple:
    """(Adam count, schedule count) of a train checkpoint's step."""
    import numpy as np
    d = out / f"step-{step:08d}-p0"
    return tuple(int(np.fromfile(d / f"opt_state.{k}.count.o.bin",
                                 dtype=np.int32)[0]) for k in ("1.0", "1.2"))


def phase_llama_train(card: str) -> dict:
    """``llama-train`` (the tiny config at its defaults: batch 2 x 256,
    head_dim 8, ``--attn auto``, which is dense as the reference's
    ``auto`` under its train mesh) as subprocesses: a fresh ``--steps 3``
    (counts 4 saved, the warm-up's update kept), ``--steps 5`` on the
    same volume (``resumed`` at 3, 2 steps), and a long ``--ckpt-every
    1`` run SIGTERM'd after its first ``checkpoint`` (``sigterm``,
    ``preempted`` with ``flushed_step``, exit 143) whose relaunch resumes
    at the flushed step; kernels 3-5 launch 0 times in these runs. And
    ``--attn flash --steps 2``, which the reference runs through its
    kernel at this shape: kernels 3-5 launch once a layer for the
    warm-up and each step. The three chains (fresh and resumed, SIGTERM
    and relaunch, flash) run side by side (:func:`_side_by_side`)."""
    import math
    import shutil
    import signal

    base = Path(__file__).resolve().parent / "build" / "lt_smoke"
    shutil.rmtree(base, ignore_errors=True)
    vol, vol2 = base / "vol", base / "vol2"
    base.mkdir(parents=True)
    problems, runs = [], {}

    def run(name, args, want_launches=0, **kw):
        t0 = time.perf_counter()
        rc, events = _worker_run(["llama-train", *args], base, **kw)
        runs[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                      "events": [e["event"] for e in events]}
        done = [e for e in events if e.get("event") == "done"]
        if done:
            launches = runs[name]["launches"] = done[0].get("launches")
            if launches is None or set(launches.values()) != {want_launches}:
                problems.append(f"{name}: kernel launches {launches}, want "
                                f"{want_launches} each")
        return rc, events, done[0] if done else {}

    def resume_chain():
        rc, _, done = run("fresh", ["--steps", str(LT_FRESH), "--out",
                                    str(vol)])
        if rc != 0 or done.get("steps_run") != LT_FRESH \
                or not math.isfinite(done.get("final_loss") or math.nan):
            problems.append(f"fresh: exit {rc}, {done}")
        elif _saved_counts(vol, LT_FRESH) != (LT_FRESH + 1,) * 2:
            problems.append(f"fresh: counts {_saved_counts(vol, LT_FRESH)}")
        rc, events, done = run("resumed", ["--steps", str(LT_RESUMED),
                                           "--out", str(vol)])
        resumed = [e["step"] for e in events if e.get("event") == "resumed"]
        if rc != 0 or resumed != [LT_FRESH] \
                or done.get("steps_run") != LT_RESUMED - LT_FRESH:
            problems.append(f"resumed: exit {rc}, resumed at {resumed}, "
                            f"{done}")

    sent, flushed = [], []

    def preempt(proc, event):
        # once: the flush emits a checkpoint event too
        if event.get("event") == "checkpoint" and not sent:
            sent.append(event["step"])
            proc.send_signal(signal.SIGTERM)

    def sigterm_chain():
        rc, events, done = run("sigterm", ["--steps", "1000000",
                                           "--ckpt-every", "1", "--out",
                                           str(vol2)], on_event=preempt)
        pre = [e for e in events if e.get("event") == "preempted"]
        flushed.append(pre[0]["flushed_step"] if pre else None)
        if rc != 143 or "sigterm" not in runs["sigterm"]["events"] \
                or len(pre) != 1 or done.get("resume_step") != flushed[0]:
            problems.append(f"sigterm: exit {rc}, events "
                            f"{runs['sigterm']['events'][-6:]}, {done}")
            return
        rc, events, done = run("relaunch", ["--steps", str(flushed[0] + 2),
                                            "--out", str(vol2)])
        resumed = [e["step"] for e in events if e.get("event") == "resumed"]
        if rc != 0 or resumed != [flushed[0]] or done.get("steps_run") != 2:
            problems.append(f"relaunch: exit {rc}, resumed at {resumed}, "
                            f"{done}")

    def flash_run():
        rc, _, done = run("flash", ["--attn", "flash", "--steps",
                                    str(LT_FLASH)],
                          want_launches=(LT_FLASH + 1) * LT_LAYERS)
        if rc != 0 or done.get("steps_run") != LT_FLASH \
                or not math.isfinite(done.get("final_loss") or math.nan):
            problems.append(f"flash: exit {rc}, {done}")

    _side_by_side(resume_chain, sigterm_chain, flash_run)
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("llama-train phase: " + "; ".join(problems))
    line = {"llama_train": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   "llama-train", "model": "tiny", "batch": 2, "seq": 256,
        "head_dim": 8,
        "attn": "auto (dense, the reference's auto under its train mesh); "
                "flash (kernels 3-5, head_dim padded to 64)",
        "flushed_step": flushed[0], "runs": runs, "card": card}}
    log(f"[llama_train] {line}")
    return line


# --------------------------------------------------------------- phase 10

# Mixtral-8x7B's routing geometry at the 8b preset's widths: 8 experts,
# top-2, dropless (the capacity default of the moe.yml service)
MOE_EXPERTS = 8
# dist/moe.yml's worker flags at the 8b preset
WORKER_MOE_ARGS = ("--pages", "-1", "--moe-experts", str(MOE_EXPERTS),
                   "--moe-capacity-factor", "0")
# moe_apply_local on the card vs the port's CPU result, both fp32 (TF32
# off): outputs within this share of max |out| (the products' sums in
# another order), and the same dropped rows
MOE_APPLY_RTOL = 1e-5
MOE_APPLY_TOKENS = 64                  # one prefill chunk
# the reckoning before the first run: weights 64.9 GB (60.13 GB of expert
# banks), every expert read each step under dropless capacity (63.9 GB,
# 19.1 ms at 3.35 TB/s)
MOE_WEIGHT_GB_PREDICTED = 64.9
# the phase and its worker run MOE_LAYERS of the 32 layers (at 32 the two
# took 74-134 s and 24-58 s of the script's 1,200 by machine; the phase
# 65-74 s at 16 and 49 s at 8 on an H100; phase 19c's ep serving pair
# runs at the same depth): every check holds at any depth, and the
# step's bound is read from the weights
MOE_LAYERS = 8
# In bf16 two valid computations of the MoE model route differently: one
# 1,500-token prompt prefilled in 64-token chunks and whole differs in
# 2,642 of its 48,000 top-2 decisions (the router logits' median
# difference 0.012, from bf16 roundings carried through the layers), and
# a flipped expert changes its token's output by a whole expert's
# contribution, so a stream's logits move by up to 0.84 at such a token.
# A stream may therefore leave the stepwise reference at any token, and
# the token-level near-tie rule cannot hold. In bf16 the share of tokens
# within NEAR_TIE_ATOL of the teacher's top logit must reach this
# (measured 0.943-0.951 over phase 3's 12 streams; a wrong expert
# product or combine puts most tokens far from the top). Exact parity
# with the reference is held in fp32 at MOE_FP32_LAYERS layers of the
# full width, where nothing flips (12 of 12 streams token-exact).
MOE_NEAR_TIE_SHARE = 0.8
MOE_FP32_LAYERS = 4


def _moe_cfg(llama):
    """Phase 10's model: Llama-3-8B's widths at ``MOE_LAYERS`` layers."""
    return dataclasses.replace(llama.LlamaConfig.llama3_8b(max_seq=2048),
                               n_layers=MOE_LAYERS)


def _moe_apply_check(params) -> dict:
    """``moe_apply_local`` on the card against the port's CPU result, in
    fp32, on layer 0's router and expert banks (cast to fp32) and
    ``MOE_APPLY_TOKENS`` random tokens: top-2 dropless, and at capacity
    factor 1.0, where tokens are dropped."""
    import torch
    from dcos_commons_tpu_torch.parallel.moe import (MoEConfig, dropless,
                                                     moe_apply_local)
    lp = params["layers"]
    dev = (lp["router"][0], lp["w_in"][0].float(), lp["w_out"][0].float())
    cpu = [t.cpu() for t in dev]
    x = torch.randn((MOE_APPLY_TOKENS, cpu[1].shape[1]),
                    generator=torch.Generator().manual_seed(SEED + 10))
    out = {}
    for name, cfg in (("top2_dropless", dropless(MoEConfig(MOE_EXPERTS))),
                      ("top2_factor_1", MoEConfig(MOE_EXPERTS,
                                                  capacity_factor=1.0))):
        want, _ = moe_apply_local(x, *cpu, cfg)
        got, _ = moe_apply_local(x.to(dev[0].device), *dev, cfg)
        got = got.cpu()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        dropped = (want == 0).all(-1)
        if err > MOE_APPLY_RTOL * scale or not torch.equal(
                (got == 0).all(-1), dropped):
            raise RuntimeError(f"moe_apply_local {name}: card vs CPU max "
                               f"|diff| {err} (tol {MOE_APPLY_RTOL} x "
                               f"{scale}), dropped rows differ or not")
        out[name] = {"max_abs_err": err, "max_abs_out": scale,
                     "dropped_tokens": int(dropped.sum()),
                     "tokens": MOE_APPLY_TOKENS}
    return out


def moe_split(srv) -> dict:
    """A graphed MoE decode step's device time by part, from the engine's
    live state (8 decoding streams): the whole step, and for every layer
    the routing (FFN norm, router product, softmax and the top-2 dispatch
    tensors), the two one-hot products (dispatch and combine), the expert
    products (two batched matmuls and the silu), the casts around them
    and kernel 1 alone. Each part is captured as its own CUDA graph on
    clones of the state and timed over replays (:func:`graph_ms`); the
    rest of the step is the attention projections, rope, the K/V writes,
    the residual adds and the lm_head."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.flash_decode import flash_decode_paged
    from dcos_commons_tpu_torch.ops.norms import rms_norm
    from dcos_commons_tpu_torch.parallel import moe as pm

    cfg, moe, dev = srv.cfg, srv.moe, srv.device
    lay = srv.params["layers"]
    nl, b = cfg.n_layers, srv.slots
    ln, tok = srv.lengths.clone(), srv.cur_tok.clone()
    mp = min(srv.pages_per_stream, int(ln.max()) // srv.page_size + 1)
    tbl = torch.tensor(srv._decode_tables()[:, :mp], device=dev)
    pool = {s: t.clone() for s, t in srv.pool.items()}
    dispatch_fn = (pm.expert_choice_dispatch
                   if moe.routing == "expert_choice" else pm.top2_dispatch)
    cap = moe.capacity(b)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(cfg.dtype)
    gates = torch.softmax(x.float() @ lay["router"][0], dim=-1)
    combine, dispatch = dispatch_fn(gates, cap)
    comb, disp = combine.to(cfg.dtype), dispatch.to(cfg.dtype)
    expert_in = torch.einsum("gec,gd->ecd", disp, x)
    q = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(cfg.dtype)
    kv_len = (ln + 1).to(torch.int32)

    def step():
        llama.decode_step_paged(cfg, srv.params, pool, tbl, ln, tok,
                                rope=srv._rope, ffn_override=srv._ffn)

    def route():
        for i in range(nl):
            h = rms_norm(x, lay["ffn_norm"][i], cfg.norm_eps)
            dispatch_fn(torch.softmax(h.float() @ lay["router"][i], dim=-1),
                        cap)

    def dispatch_combine():
        for _ in range(nl):
            torch.einsum("gec,gd->ecd", disp, x)
            torch.einsum("gec,ecd->gd", comb, expert_in)

    def experts():
        for i in range(nl):
            h = torch.bmm(expert_in, lay["w_in"][i])
            torch.bmm(h * torch.sigmoid(h), lay["w_out"][i])

    def casts():
        for _ in range(nl):
            x.float()
            combine.to(cfg.dtype)
            dispatch.to(cfg.dtype)
            (x + x.float().to(cfg.dtype))

    def kernel_1():
        for i in range(nl):
            flash_decode_paged(q, pool["k"][i], pool["v"][i], tbl, kv_len)

    parts = {"route_ms": graph_ms(route),
             "dispatch_combine_ms": graph_ms(dispatch_combine),
             "expert_products_ms": graph_ms(experts),
             "casts_ms": graph_ms(casts),
             "kernel_1_ms": graph_ms(kernel_1)}
    step_ms = graph_ms(step)
    del pool
    expert_bytes = sum(lay[k].numel() * lay[k].element_size()
                       for k in ("w_in", "w_out"))
    return {"batch": b, "capacity": cap, "table_width": mp,
            "positions_max": int(ln.max()) + 1, "step_ms": step_ms, **parts,
            "rest_ms": step_ms - sum(parts.values()),
            "expert_share": parts["expert_products_ms"] / step_ms,
            "expert_bytes_gb": expert_bytes / 1e9,
            "expert_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
            "expert_gb_per_s": expert_bytes / parts["expert_products_ms"]
            / 1e6}


def phase_moe(card: str) -> tuple:
    """MoE serving in process at Llama-3-8B widths with 8 experts
    (top-2, dropless) at ``MOE_LAYERS`` layers (:func:`_moe_cfg`):
    ``init_moe_params`` from the seed,
    ``PagedServer(moe=...)`` warmed up, then with the kernel counts zeroed
    phase 3's 12 requests drained as phase 3 drains them, the workers' 8
    requests drained at window 8 (the tokens the MoE worker is held to),
    and each of the 12 streams decoded alone by ``generate_stepwise_moe``
    (kernel 2); the counts are read after. The engine's streams are held
    to the MoE target by :func:`moe_stream_share`, ``moe_apply_local`` on
    the card to the CPU, graphed windows bitwise to the eager loop at
    B=8, and, once the bf16 model is freed, the engine to
    ``generate_stepwise_moe`` token for token in fp32 at reduced depth
    (:func:`_moe_fp32_parity`). Returns (line, launches, the workers'
    streams from the engine)."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    dev = torch.device("cuda")
    resident_gb = torch.cuda.memory_allocated() / 1e9
    if resident_gb > 4:
        raise RuntimeError(f"moe phase: {resident_gb:.1f} GB still resident "
                           "before the 65 GB MoE weights")
    cfg = _moe_cfg(llama)
    moe = dropless(MoEConfig(MOE_EXPERTS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_moe_params(
        cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size()
                    for t in [params["embed"], params["norm"],
                              params["lm_head"], *params["layers"].values()]
                    ) / 1e9
    log(f"[moe] init {weight_gb:.2f} GB of MoE params in {init_s:.1f} s")
    # dropless: every expert of every layer and the head read each step
    step_bound_ms = (weight_gb - params["embed"].numel()
                     * params["embed"].element_size() / 1e9) \
        * 1e9 / HBM_BYTES_PER_S * 1e3
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, moe=moe, device=dev)
    warm = srv.warmup()
    queue = serve_queue(cfg.vocab_size)
    workers = [{"prompt": b["prompt"], "max_new": b["max_new"],
                "request_id": f"w{i}"} for i, b in enumerate(worker_bodies())]
    prompts = {r["request_id"]: r["prompt"] for r in queue + workers}
    fd.flash_decode_paged.launches = 0
    fd.flash_decode.launches = 0
    wall, ttft = drain_timed(srv, queue)
    out = {rid: srv.finished[rid] for rid in prompts if rid in srv.finished}
    worker_want = srv.drain([dict(r) for r in workers], decode_window=8)
    worker_want = {rid: worker_want[rid] for rid in prompts
                   if rid.startswith("w")}
    t_ref = time.perf_counter()
    want = {r["request_id"]: llama.generate_stepwise_moe(
        cfg, params, torch.tensor([r["prompt"]], dtype=torch.int32,
                                  device=dev), r["max_new"], moe)[0].tolist()
        for r in queue}
    ref_s = time.perf_counter() - t_ref
    launches = {"flash_decode_paged": fd.flash_decode_paged.launches,
                "flash_decode": fd.flash_decode.launches}
    problems = []
    if sorted(out) != sorted(want) or sorted(worker_want) != sorted(
            r["request_id"] for r in workers):
        problems.append(f"finished {sorted(out)} {sorted(worker_want)}")
    for rid, toks in {**out, **worker_want}.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            problems.append(f"{rid}: {len(toks)} tokens or one outside the "
                            "vocabulary")
    if srv.ledger_violations():
        problems.append(f"ledger: {srv.ledger_violations()[:3]}")
    stats = srv.page_stats()
    if stats["prefix_hits"] < 1:
        problems.append("no prefix hit")
    for name, n in launches.items():
        if n < 1:
            problems.append(f"{name} never launched on the MoE path")
    if problems:
        raise RuntimeError("moe phase: " + "; ".join(problems))
    differ = sum(a != b for rid in want for a, b in zip(out[rid], want[rid]))
    near_tie = moe_stream_share("moe engine vs generate_stepwise_moe", out,
                                want, prompts, cfg, params, srv._ffn)
    apply_check = _moe_apply_check(params)
    t_chunk = []
    row = torch.full((srv.pages_per_stream,), srv.scratch, dtype=torch.int32,
                     device=dev)
    chunk = torch.zeros((1, srv.prefill_chunk), dtype=torch.int32, device=dev)
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        llama.prefill_chunk_paged(cfg, params, srv.pool, row, chunk, 0,
                                  srv.prefill_chunk, srv.prefill_chunk - 1,
                                  srv.scratch, rope=srv._rope,
                                  ffn_override=srv._ffn)
        torch.cuda.synchronize()
        t_chunk.append((time.perf_counter() - t1) * 1e3)
    steady_streams(srv)
    steady = _graph_vs_eager(srv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(t) for t in out.values())
    ttfts = sorted(ttft.values())
    line = {"moe": {
        "model": f"llama3_8b widths, {MOE_LAYERS} of 32 layers, 8 experts "
                 "top-2 (Mixtral-8x7B routing geometry)",
        "max_seq": cfg.max_seq, "layers": cfg.n_layers, "dtype": "bf16",
        "experts": MOE_EXPERTS, "routing": moe.routing,
        "capacity_factor": moe.capacity_factor, "slots": 8, "page_size": 64,
        "prefill_chunk": 64, "weight_gb": weight_gb,
        "weight_gb_predicted_32_layers": MOE_WEIGHT_GB_PREDICTED,
        "init_s": init_s,
        "warmup_s": warm, "requests": len(out), "tokens_out": n_tok,
        "wall_s": wall, "output_tok_s": n_tok / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "decode_step_ms_b8": steady["graph_step_ms"],
        "eager_step_ms_b8": steady["eager_step_ms"],
        "decode_tok_s_b8": 8 / steady["graph_step_ms"] * 1e3,
        "step_bound_ms": step_bound_ms,
        "prefill_chunk_ms": sorted(t_chunk)[len(t_chunk) // 2],
        "prefill_chunk_ms_all": t_chunk, "steady_b8_window8": steady,
        "stepwise_reference_s": ref_s, "tokens_differing_from_stepwise":
            differ, "bf16_vs_stepwise": near_tie,
        "moe_apply_card_vs_cpu": apply_check, "launches": launches,
        "peak_mem_gb": peak_gb, "page_stats_moe": stats["moe"],
        "page_stats": stats, "graphs": _graph_line(srv), "card": card}}
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    line["moe"]["fp32_parity"] = _moe_fp32_parity(queue)
    log(f"[moe] {line}")
    return line, launches, worker_want


def moe_stream_share(name, got, want, prompts, cfg, params, ffn) -> dict:
    """Each bf16 stream of ``got`` teacher-forced through the MoE target
    (:func:`_teacher_gaps`): the share of tokens within ``NEAR_TIE_ATOL``
    of the top logit at their position must reach ``MOE_NEAR_TIE_SHARE``
    (see there). Returns where each stream first leaves ``want``, the
    share and the largest gap; raises below the share."""
    from dcos_commons_tpu_torch.ops.rotary import rope_frequencies
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=params["norm"].device)
    gaps, divergences = [], []
    for rid, w in want.items():
        g = got[rid]
        row = _teacher_gaps(cfg, params, rope, prompts[rid], g, ffn)
        gaps += row
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            divergences.append({"stream": rid, "at": j, "gap": row[j]})
    share = sum(gap <= NEAR_TIE_ATOL for gap in gaps) / len(gaps)
    out = {"tokens": len(gaps), "near_tie_share": share,
           "near_tie_share_floor": MOE_NEAR_TIE_SHARE,
           "tokens_away_from_a_near_tie": sum(gap > NEAR_TIE_ATOL
                                              for gap in gaps),
           "max_gap": max(gaps), "streams_equal": len(want) - len(
               divergences), "divergences": divergences}
    log(f"[check] {name}: {out}")
    if share < MOE_NEAR_TIE_SHARE:
        raise RuntimeError(f"{name}: only {share:.3f} of {len(gaps)} tokens "
                           f"within {NEAR_TIE_ATOL} of the target's top "
                           f"logit (floor {MOE_NEAR_TIE_SHARE})")
    return out


def _moe_fp32_parity(queue) -> dict:
    """The MoE engine against ``generate_stepwise_moe`` on the card in
    fp32 (TF32 off) at the full width with ``MOE_FP32_LAYERS`` layers and
    8 experts (dense attention: the decode kernels take bf16): phase 3's
    12 requests drained as phase 3 drains them, every stream token-exact,
    as on the CPU. Frees what it builds."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048, n_layers=MOE_FP32_LAYERS,
                                      dtype=torch.float32,
                                      decode_attn="dense")
    moe = dropless(MoEConfig(MOE_EXPERTS))
    params = llama.init_moe_params(
        cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, moe=moe, device=dev)
    t0 = time.perf_counter()
    drain_timed(srv, queue)
    differ = {}
    for r in queue:
        want = llama.generate_stepwise_moe(
            cfg, params, torch.tensor([r["prompt"]], dtype=torch.int32,
                                      device=dev), r["max_new"], moe)
        got = srv.finished[r["request_id"]]
        if got != want[0].tolist():
            differ[r["request_id"]] = next(
                i for i, (a, b) in enumerate(zip(got, want[0].tolist()))
                if a != b)
    seconds = time.perf_counter() - t0
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    if differ:
        raise RuntimeError(f"moe fp32 parity: streams leave "
                           f"generate_stepwise_moe at {differ}")
    return {"layers": MOE_FP32_LAYERS, "dtype": "fp32", "streams_equal":
            len(queue), "of": len(queue), "seconds": seconds}


def phase_moe_worker(card, want) -> tuple:
    """The worker with dist/moe.yml's flags at the 8b preset
    (``WORKER_MOE_ARGS``), cut to ``MOE_LAYERS`` layers (``CUT_WORKER``)
    as phase 10 is: ``moe_fallback`` or ``paged_fallback`` fails
    the phase; the 8 worker requests, each reply held to the in-process
    engine's stream for the same prompt ``want`` (the same weights, drawn
    from seed 0 by the same function): equal, or, where streams leave
    it, held by :func:`moe_stream_share` (weights drawn again once the
    worker has exited).
    Kernel 1's launches are the worker's while it served, kernel 2's its
    timed decode's (``generate_stepwise_moe`` before serving). Returns
    (line, launches)."""
    import torch
    line, launches, replies, events = phase_worker(
        card, "worker_moe", WORKER_MOE_ARGS, "PagedServer",
        ("flash_decode_paged",),
        forbid=("paged_fallback", "moe_fallback"),
        launch=("-c", CUT_WORKER, str(MOE_LAYERS)))
    body = line["worker_moe"]
    serving = next(e for e in events if e.get("event") == "serving")
    launches["flash_decode"] = serving.get("launches", {}).get(
        "flash_decode", 0)
    problems = []
    if launches["flash_decode"] < 1:
        problems.append("the worker's timed decode never launched "
                        "flash_decode")
    moe_stats = (body.get("paged") or {}).get("moe")
    if moe_stats != {"experts": MOE_EXPERTS,
                     "capacity_factor": float(MOE_EXPERTS),
                     "routing": "top2"}:
        problems.append(f"page_stats moe {moe_stats}")
    if problems:
        raise RuntimeError("worker_moe phase: " + "; ".join(problems))
    got = {f"w{i}": toks for i, toks in enumerate(replies)}
    differ = [rid for rid in want if got[rid] != want[rid]]
    body["streams_equal_in_process"] = len(want) - len(differ)
    body["bf16_vs_in_process"] = None
    if differ:
        from dcos_commons_tpu_torch.models import llama
        from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless
        dev = torch.device("cuda")
        cfg = _moe_cfg(llama)
        params = llama.init_moe_params(
            cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
            device=dev)
        prompts = {f"w{i}": b["prompt"]
                   for i, b in enumerate(worker_bodies())}
        body["bf16_vs_in_process"] = moe_stream_share(
            "MoE worker vs the in-process engine",
            {rid: got[rid] for rid in differ},
            {rid: want[rid] for rid in differ}, prompts, cfg, params,
            llama.make_moe_ffn(cfg, dropless(MoEConfig(MOE_EXPERTS))))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    body["model"] = (f"llama3_8b widths, {MOE_LAYERS} of 32 layers, 8 "
                     "experts top-2 (Mixtral-8x7B routing geometry)")
    body["launches"] = launches
    log(f"[worker_moe] streams equal {body['streams_equal_in_process']}, "
        f"bf16 hold {body['bf16_vs_in_process']}")
    return line, launches


# --------------------------------------------------------------- phase 4

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 512, 10
FA_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
              "flash_attention_bwd_dq")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def phase_train(card: str):
    """bench.py's headline llama line through the port: llama_400m at
    full width and depth, batch 16 x 512, fused CE, AdamW warmup 10."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import llama, train
    from dcos_commons_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama_400m(max_seq=TRAIN_SEQ, remat=False)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    named = list(_named(params))
    n_params = sum(t.numel() for _, t in named)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    opt = train.make_optimizer(lr=3e-4, warmup=10, decay_steps=1000)
    state = train.init_opt_state(opt, params)
    step = train.make_train_step(lambda p, b: llama.loss_fn(cfg, p, b), opt)

    t0 = time.perf_counter()
    params, state, out = step(params, state, toks)          # warm-up
    losses = [out["loss"]]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counters = [getattr(fa, name) for name in FA_KERNELS]
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, out = step(params, state, toks)
        losses.append(out["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {name: c.launches for name, c in zip(FA_KERNELS, counters)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in torch.stack(losses).float().cpu()]
    log(f"[train] warm-up step {warm_s:.2f} s, {step_s * 1e3:.2f} ms a "
        f"step, losses {losses}, launches {launches}")

    # one loss forward + backward through the kernels vs the dense path
    grads, loss = {}, {}
    leaves = [t for _, t in named]
    for mode in ("auto", "dense"):
        for t in leaves:
            t.requires_grad_(True)
        l_mode, _ = llama.loss_fn(dataclasses.replace(cfg, attn_impl=mode),
                                  params, toks)
        grads[mode] = torch.autograd.grad(l_mode, leaves)
        loss[mode] = float(l_mode.detach())
        for t in leaves:
            t.requires_grad_(False)
    rel = {name: float((gk.float() - gd.float()).norm()
                       / gd.float().norm().clamp_min(1e-30))
           for (name, _), gk, gd in zip(named, grads["auto"], grads["dense"])}
    worst = max(rel, key=rel.get)
    loss_diff = abs(loss["auto"] - loss["dense"])

    problems = []
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        problems.append(f"launches {launches}, expected {want} of each")
    if not all(np.isfinite(losses)):
        problems.append(f"non-finite loss: {losses}")
    elif not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses}")
    if loss_diff > LOSS_ATOL or rel[worst] > GRAD_RTOL:
        problems.append(f"kernel vs dense: loss diff {loss_diff:.3e} (tol "
                        f"{LOSS_ATOL}), worst grad {worst} {rel[worst]:.3e} "
                        f"(tol {GRAD_RTOL})")
    if problems:
        raise RuntimeError("training phase: " + "; ".join(problems))

    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ - 1)  # next-token loss
    flops_per_step = 6.0 * n_params * tokens_per_step
    return {"training": {
        "model": "llama_400m", "layers": cfg.n_layers, "dim": cfg.dim,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "params": n_params, "dtype": "bf16", "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "tokens_per_step": tokens_per_step,
        "grad_accum": 1, "fused_ce": cfg.fused_ce, "remat": cfg.remat,
        "attn_impl": cfg.attn_impl, "steps_timed": TRAIN_STEPS,
        "warmup_step_s": warm_s, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens_per_step / step_s,
        "mfu": flops_per_step / step_s / BF16_OPS_PER_S,
        "bound_step_ms": flops_per_step / BF16_OPS_PER_S * 1e3,
        "peak_mem_gb": peak_gb, "loss_first": losses[0],
        "loss_last": losses[-1], "losses": losses,
        "launches_per_step": {k: n / TRAIN_STEPS
                              for k, n in launches.items()},
        "kernel_vs_dense": {
            "loss_kernel": loss["auto"], "loss_dense": loss["dense"],
            "loss_abs_diff": loss_diff, "loss_tol": LOSS_ATOL,
            "grad_max_rel_err": rel[worst], "grad_worst_leaf": worst,
            "grad_tol": GRAD_RTOL},
        "card": card}}, launches


# -------------------------------------------------------------- phase 11

# the KV hierarchy's traffic: 8 tenants, each a 1,024-token system prompt
# (16 full pages of 64) from its own seed, then a user turn of 64-192
# tokens, 32 new tokens greedy; round 2 sends every tenant a new turn
# (serve_tier_rounds says in what order)
TIER_TENANTS, TIER_SYS, TIER_TURN, TIER_NEW = 8, 1024, (64, 192), 32
TIER_ENGINE = dict(slots=8, page_size=64, prefill_chunk=64)
# a 64-page pool under 128 prefix pages, tiers of 32 host + 96 disk pages;
# the untiered engine it is held to keeps every prefix in its 256 pages
TIER_POOL, TIER_HOST, TIER_DISK, TIER_BIG_POOL = 64, 32, 96, 256
# the int8 check: two tenants, a host tier of 16 so it spills to disk
TIER_INT8_TENANTS, TIER_INT8_HOST = 2, 16
# graph vs eager after a promote: 2 streams, 3 windows of 8
TIER_GRAPH_STREAMS, TIER_GRAPH_WINDOWS = 2, 3
WORKER_TIER_ARGS = ("--pages", str(TIER_POOL), "--kv-tier-host-pages",
                    str(TIER_HOST), "--kv-tier-disk-dir", "{disk}",
                    "--kv-tier-disk-pages", str(TIER_DISK))


def tier_rounds(v: int, tenants: int = TIER_TENANTS) -> list:
    """Two rounds of one request per tenant, from the seed: the tenant's
    system prompt (its own seed) and a user turn; a round-2 turn starts
    with another token than the round-1 turn, so the boundary
    copy-on-write never fires and the tail starts at position 1,024."""
    import numpy as np
    rng = np.random.default_rng(SEED + 11)
    systems = [_prompt(np.random.default_rng(SEED + 1100 + t), TIER_SYS, v)
               for t in range(tenants)]
    rounds, firsts = [], {}
    for r in range(3):
        reqs = []
        for t in range(tenants):
            turn = _prompt(rng, int(rng.integers(TIER_TURN[0],
                                                 TIER_TURN[1] + 1)), v)
            while turn[0] in firsts.get(t, ()):
                turn[0] = (turn[0] + 1) % v
            firsts.setdefault(t, set()).add(turn[0])
            reqs.append({"prompt": systems[t] + turn, "max_new": TIER_NEW,
                         "request_id": f"t{t}-r{r + 1}"})
        rounds.append(reqs)
    return rounds


def serve_tier_rounds(srv, rounds) -> list:
    """Round 1's requests at once, then round 2's one after another, each
    after the previous reply and the tenant served last in round 1 first
    (its prefix is the warmest): per round, {request: tokens}. Served all
    at once, each round-2 admission would evict the pages its own plan
    is about to promote out of the host tier before the promote lands,
    and no promote would hit the host tier (measured on the CPU)."""
    got = srv.drain([dict(r) for r in rounds[0]], decode_window=8)
    out = [{r["request_id"]: got[r["request_id"]] for r in rounds[0]}, {}]
    for r in reversed(rounds[1]):
        out[1][r["request_id"]] = srv.drain([dict(r)], decode_window=8)[
            r["request_id"]]
    return out


def tier_worker_rounds(rounds) -> list:
    """The worker's waves of request bodies in :func:`serve_tier_rounds`'
    order: round 1 at once, then round 2 one by one."""
    def body(r):
        return {"prompt": r["prompt"], "max_new": r["max_new"]}
    return [[body(r) for r in rounds[0]]] + [[body(r)]
                                             for r in reversed(rounds[1])]


def _same_bits(a, b) -> bool:
    """Two gathered payloads (CPU tensors, ``{"q", "s"}`` for int8) are
    bitwise equal."""
    import torch

    def parts(p):
        out = []
        for side in ("k", "v"):
            val = p[side]
            out += [val["q"], val["s"]] if isinstance(val, dict) else [val]
        return out

    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(parts(a), parts(b)))


def _page_of(payload, j: int):
    """Page ``j`` of a gathered span, as a one-page payload."""
    def one(x):
        if isinstance(x, dict):
            return {k: v[:, j:j + 1].contiguous() for k, v in x.items()}
        return x[:, j:j + 1].contiguous()
    return {side: one(payload[side]) for side in ("k", "v")}


def checked_server(*args, watch=(), **kw):
    """A ``PagedServer`` that, for the smoke's byte checks, saves the
    pages of each watched chain as the radix first evicts it (gathered
    before the demote runs), and holds every page a promote installs
    against that copy and every page an adoption installs against the
    span it fetched. Everything else is the engine's own path."""
    from dcos_commons_tpu_torch.models import serving
    from dcos_commons_tpu_torch.models.paging import chain_keys

    class Checked(serving.PagedServer):
        def __init__(self):
            super().__init__(*args, **kw)
            self.watch, self.saved = set(watch), {}
            self.checked, self.mismatched, self.fetched = 0, [], None

        def _demote(self, page, prefix_tokens):
            ck = chain_keys(prefix_tokens, self.page_size)[-1]
            if ck in self.watch and ck not in self.saved:
                self.saved[ck] = self._gather_span([page])
            super()._demote(page, prefix_tokens)

        def _installed(self, slot, a, b):
            return self._gather_span(self._stream_pages[slot][a:b])

        def _promote_from_tier(self, plan):
            ok = super()._promote_from_tier(plan)
            if ok:
                slot, base = plan["slot"], plan["base"]
                m = self._prefill_pos[slot] // self.page_size - base
                got = self._installed(slot, base, base + m)
                for j, ck in enumerate(plan["chains"][:m]):
                    if ck in self.saved:
                        self.checked += 1
                        if not _same_bits(_page_of(got, j), self.saved[ck]):
                            self.mismatched.append(ck)
            return ok

        def _adopt_from_fleet(self, plan):
            ok = super()._adopt_from_fleet(plan)
            if ok:
                slot, base = plan["slot"], plan["base"]
                cover = self._prefill_pos[slot] // self.page_size
                got = self._installed(slot, base, cover)
                span = self.fetched["payload"]
                for j in range(cover - base):
                    self.checked += 1
                    if not _same_bits(_page_of(got, j),
                                      _page_of(span, base + j)):
                        self.mismatched.append((plan["holder"], base + j))
            return ok

    return Checked()


def _owner_overlap(srv) -> list:
    """Chains both in the radix and in the tier store (must be none)."""
    from dcos_commons_tpu_torch.models.paging import chain_keys
    radix = {chain_keys(srv.radix.prefix_tokens(n), srv.page_size)[-1]
             for n in srv.radix._iter_nodes()}
    return sorted(radix & set(srv.tiers.chains()))


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def first_token(srv, req) -> dict:
    """Serve ``req`` alone with max_new 1 (it retires at its first token,
    so no decode window runs): seconds from submit to the token on the
    host, each step's seconds (one prefill chunk each, synchronised),
    and what the engine's promote/adoption counters gained."""
    before = (srv.tier_promote_s, srv.tier_promoted_pages,
              srv.adopted_prefix_pages)
    _sync(srv.device)
    t0 = time.perf_counter()
    srv.submit(req["prompt"], 1, request_id=req["request_id"])
    steps = []
    while req["request_id"] not in srv.finished:
        t = time.perf_counter()
        srv.step()
        _sync(srv.device)
        steps.append(time.perf_counter() - t)
    ttft = time.perf_counter() - t0
    return {"ttft_s": ttft, "step_s": steps,
            "token": srv.finished.pop(req["request_id"])[0],
            "promote_s": srv.tier_promote_s - before[0],
            "promoted_pages": srv.tier_promoted_pages - before[1],
            "adopted_pages": srv.adopted_prefix_pages - before[2]}


def _tier_engine_checks(name, srv, store, problems, fallbacks_ok=False):
    st = store.stats()
    if srv.ledger_violations():
        problems.append(f"{name}: ledger {srv.ledger_violations()[:3]}")
    if _owner_overlap(srv):
        problems.append(f"{name}: chains in the radix AND the tiers "
                        f"{_owner_overlap(srv)[:3]}")
    if srv.mismatched:
        problems.append(f"{name}: {len(srv.mismatched)} promoted pages "
                        f"differ from the pages demoted")
    if srv.checked < 1:
        problems.append(f"{name}: no promoted page was checked")
    if not fallbacks_ok and srv.tier_fallbacks:
        problems.append(f"{name}: tier_fallbacks {srv.tier_fallbacks}")
    if st["host_hits"] < 1 or st["disk_hits"] < 1 or st["dropped"]:
        problems.append(f"{name}: tier stats {st}")
    return st


def phase_kv_tiers(card: str, params, cfg=None, dev=None,
                   tenants: int = TIER_TENANTS, int8_layers=None) -> tuple:
    """The paged engine's KV hierarchy on phase 3's weights: (1) the
    tiered engine (``pages=64``, tiers of 32 host + 96 disk pages) after
    ``warmup()`` serves two rounds of the tenants' traffic; every page a
    promote installs is bitwise the page as it was before its first
    demote, host and disk both hit, nothing falls back or drops, the
    ledger is clean and no chain is in the radix and a tier at once;
    (2) an untiered engine of 256 pages serves the same rounds, token for
    token the same; (3) the int8 pool repeats (1) for two tenants; (4)
    after a promote, graphed windows equal the eager loop bitwise; (5)
    replica B (empty radix, a directory naming the untiered engine behind
    a front door on localhost, ``peer_fetch=fetch_prefix``) serves round
    2 with the untiered engine's tokens and pages; then the demote,
    promote and adoption times and the time to first token by promote,
    by adoption and by recompute. Kernel-1 launches are counted over
    (1). ``cfg``/``dev`` default to Llama-3-8B on the card (a smaller
    model on the CPU rehearses the control flow)."""
    import hashlib
    import shutil
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.models.disagg import fetch_prefix
    from dcos_commons_tpu_torch.models.ingress import ServingFrontend
    from dcos_commons_tpu_torch.models.paging import (
        PageTierStore, PrefixDirectory, chain_keys, pack_page_frame)
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    dev = dev or torch.device("cuda")
    cfg = cfg or llama.LlamaConfig.llama3_8b(max_seq=2048)
    v = cfg.vocab_size
    rounds = tier_rounds(v, tenants)
    watch = {ck for req in rounds[0]
             for ck in chain_keys(req["prompt"][:TIER_SYS], 64)}
    root = Path(__file__).resolve().parent / "build" / "kv_tier_smoke"
    shutil.rmtree(root, ignore_errors=True)
    problems, t_phase = [], time.perf_counter()
    out = {}
    try:
        # (1) the tiered engine
        store = PageTierStore(host_pages=TIER_HOST,
                              disk_dir=str(root / "disk"),
                              disk_pages=TIER_DISK)
        srv = checked_server(cfg, params, pages=TIER_POOL, tiers=store,
                             watch=watch, device=dev, **TIER_ENGINE)
        warm = srv.warmup()
        fd.flash_decode_paged.launches = 0
        t0 = time.perf_counter()
        tiered = serve_tier_rounds(srv, rounds)
        _sync(dev)
        tiered_s = time.perf_counter() - t0
        launches = fd.flash_decode_paged.launches
        st = _tier_engine_checks("tiered engine", srv, store, problems)
        checked = srv.checked
        if dev.type == "cuda" and launches < 1:
            problems.append("flash_decode_paged never launched in phase 11")
        stats = srv.page_stats()
        # (2) the untiered engine behind a front door (replica A of (5))
        directory = PrefixDirectory(max_age_s=600.0)
        big = serving.PagedServer(cfg, params, pages=TIER_BIG_POOL,
                                  directory=directory, device=dev,
                                  **TIER_ENGINE)
        fe = ServingFrontend(big, port=0, host="127.0.0.1")
        big.replica_id = f"http://127.0.0.1:{fe.port}"
        big.warmup()
        flat = serve_tier_rounds(big, rounds)
        distinct = {ck for reqs in rounds[:2] for r in reqs
                    for ck in chain_keys(r["prompt"], 64)}
        big_radix = big.radix.size()
        for r in (0, 1):
            diff = [rid for rid in flat[r] if flat[r][rid] != tiered[r][rid]]
            if diff or sorted(flat[r]) != sorted(tiered[r]):
                problems.append(f"round {r + 1}: tiered tokens differ from "
                                f"the untiered engine's for {diff}")
        # (4) graph vs eager after a promote: every radix page to the
        # tiers, then two streams promote their prefixes and decode
        srv._evict(srv.ledger.pages)
        for req in rounds[1][:TIER_GRAPH_STREAMS]:   # served last
            srv.submit(req["prompt"], 200, request_id=("graph",
                                                       req["request_id"]))
        promoted0 = srv.tier_promoted_pages
        while srv._pending_tier or srv._prefill_q or srv._pending_first:
            srv.step()
        if srv.tier_promoted_pages - promoted0 < 16:
            problems.append("graph check: the streams promoted "
                            f"{srv.tier_promoted_pages - promoted0} pages")
        try:
            graph = _graph_vs_eager(srv, windows=TIER_GRAPH_WINDOWS, k=8)
        except RuntimeError as e:        # reported with the other checks
            problems.append(f"after a promote: {e}")
        srv.abort_active()
        # (5) replica B adopts round 2 from A over /v1/prefix
        fe.start()
        try:
            def fetch(holder, prompt):
                b.fetched = fetch_prefix(holder, prompt, timeout_s=120.0)
                return b.fetched

            b = checked_server(cfg, params, pages=TIER_POOL,
                               directory=directory, replica_id="replica-b",
                               peer_fetch=fetch, device=dev, **TIER_ENGINE)
            b.warmup()
            adopted = {}
            for r in reversed(rounds[1]):
                adopted[r["request_id"]] = b.drain(
                    [dict(r)], decode_window=8)[r["request_id"]]
            diff = [rid for rid in adopted if adopted[rid] != flat[1][rid]]
            if diff:
                problems.append(f"replica B's tokens differ from A's for "
                                f"{diff}")
            if b.directory_hits < 1 or b.mismatched or b.checked < 1:
                problems.append(f"replica B: {b.directory_hits} directory "
                                f"hits, {b.checked} pages checked, "
                                f"{len(b.mismatched)} differ")
            fleet_stats = b.page_stats()
            # adoption of a 16-page prefix: a new turn of tenant 0
            b.reset()
            req3 = dict(rounds[2][0], request_id="fleet-16")
            fleet = first_token(b, req3)
        finally:
            fe.stop()
        del b, big, fe
        gc.collect()
        # times: recompute on an untiered 64-page engine, then the tiered
        # engine's demote and promote through the host and the disk tier
        rec = serving.PagedServer(cfg, params, pages=TIER_POOL, device=dev,
                                  **TIER_ENGINE)
        rec.warmup()
        recompute = first_token(rec, dict(req3, request_id="recompute"))
        del rec
        srv.reset()
        store.clear()
        first_token(srv, dict(req3, request_id="seed"))
        timings = {}
        for tier, tstore in (("host", store), ("disk", PageTierStore(
                host_pages=0, disk_dir=str(root / "disk_only"),
                disk_pages=TIER_DISK))):
            srv.tiers = tstore
            _sync(dev)
            t0 = time.perf_counter()
            n = srv._evict(srv.ledger.pages)
            dt = time.perf_counter() - t0
            got = first_token(srv, dict(req3, request_id=f"promote-{tier}"))
            if got["token"] != recompute["token"] or got["promoted_pages"] \
                    != (len(req3["prompt"]) - 1) // 64:
                problems.append(f"{tier} promote: {got}")
            timings[tier] = {"demote_ms_per_page": dt / n * 1e3,
                             "demoted_pages": n, **got,
                             "promote_ms_per_page": got["promote_s"]
                             / max(got["promoted_pages"], 1) * 1e3}
        srv.tiers = store
        if fleet["token"] != recompute["token"] or fleet["adopted_pages"] \
                != TIER_SYS // 64:
            problems.append(f"16-page adoption: {fleet}")
        # blake2s over one page's frame: once in pack, once in unpack
        frame = pack_page_frame({"chain": "c", "page_hash": "h",
                                 "kv_quant": False,
                                 "payload": srv._gather_span([0])})
        t0 = time.perf_counter()
        for _ in range(5):
            hashlib.blake2s(frame).hexdigest()
        blake_ms = (time.perf_counter() - t0) / 5 * 1e3
        del srv
        gc.collect()
        # (3) int8 pages, two tenants
        cfg8 = dataclasses.replace(cfg, kv_quant=True)
        if int8_layers:
            cfg8 = dataclasses.replace(cfg8, n_layers=int8_layers)
            params8 = {**params, "layers": {
                k: w[:int8_layers] for k, w in params["layers"].items()}}
        else:
            params8 = params
        store8 = PageTierStore(host_pages=TIER_INT8_HOST,
                               disk_dir=str(root / "disk_int8"),
                               disk_pages=TIER_DISK)
        reqs8 = [r[:TIER_INT8_TENANTS] for r in rounds[:2]]
        s8 = checked_server(cfg8, params8, pages=TIER_POOL, tiers=store8,
                            watch=watch, device=dev, **TIER_ENGINE)
        s8.warmup()
        s8.drain([dict(r) for r in reqs8[0]], decode_window=8)
        s8._evict(s8.ledger.pages)         # 2 tenants fit: demote them
        for r in reversed(reqs8[1]):
            s8.drain([dict(r)], decode_window=8)
        st8 = _tier_engine_checks("int8 engine", s8, store8, problems)
        int8 = {"layers": cfg8.n_layers, "tenants": TIER_INT8_TENANTS,
                "host_pages": TIER_INT8_HOST, "checked_pages": s8.checked,
                "demoted": s8.tier_demoted_pages,
                "promoted": s8.tier_promoted_pages, "tiers": st8}
        del s8
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise RuntimeError("kv tiers phase: " + "; ".join(problems[:8]))
    page_bytes = len(frame)
    line = {"kv_tiers": {
        "model": "llama3_8b" if cfg.n_layers == 32 else "rehearsal",
        "layers": cfg.n_layers, "max_seq": cfg.max_seq,
        "dtype": str(cfg.dtype).split(".")[-1],
        **TIER_ENGINE, "pages": TIER_POOL, "host_pages": TIER_HOST,
        "disk_pages": TIER_DISK, "tenants": tenants,
        "system_tokens": TIER_SYS, "turn_tokens": list(TIER_TURN),
        "max_new": TIER_NEW, "warmup_s": warm,
        "two_rounds_s": tiered_s,
        "demote_ms_per_page_host": timings["host"]["demote_ms_per_page"],
        "demote_ms_per_page_disk": timings["disk"]["demote_ms_per_page"],
        "promote_ms_per_page_host": timings["host"]["promote_ms_per_page"],
        "promote_ms_per_page_disk": timings["disk"]["promote_ms_per_page"],
        "blake2s_ms_per_page": blake_ms,
        "blake2s_share_of_demote_host":
            blake_ms / timings["host"]["demote_ms_per_page"],
        "blake2s_share_of_promote_host":
            blake_ms / timings["host"]["promote_ms_per_page"],
        "blake2s_share_of_promote_disk":
            blake_ms / timings["disk"]["promote_ms_per_page"],
        "ttft_s_promote_host": timings["host"]["ttft_s"],
        "ttft_s_promote_disk": timings["disk"]["ttft_s"],
        "ttft_s_adopt_16_pages": fleet["ttft_s"],
        "ttft_s_recompute": recompute["ttft_s"],
        "adopt_ms_16_pages": fleet["promote_s"] * 1e3,
        "recompute_ms_16_pages": sum(recompute["step_s"][:16]) * 1e3,
        "ttft_request_tokens": len(req3["prompt"]),
        "frame_bytes_per_page": page_bytes,
        "bytes_framed": stats["tier_demoted_pages"] * page_bytes,
        "counters": {k: stats[k] for k in (
            "tier_demoted_pages", "tier_promoted_pages", "tier_fallbacks",
            "tier_promote_s", "prefix_hits", "prefix_shared_pages")},
        "tiers": st, "checked_pages": checked,
        "tokens_equal_untiered": True,
        "untiered_radix_pages": big_radix,
        "distinct_prefix_pages": len(distinct),
        "fleet": {k: fleet_stats[k] for k in (
            "directory_hits", "directory_fallbacks",
            "adopted_prefix_pages")}, "int8": int8,
        "graph_vs_eager_after_promote": {
            k: graph[k] for k in ("batch", "windows", "k", "tokens_equal",
                                  "kv_bitwise_equal", "graph_step_ms",
                                  "eager_step_ms")},
        "launches": {"flash_decode_paged": launches},
        "phase_s": time.perf_counter() - t_phase, "card": card}}
    log(f"[kv_tiers] {line}")
    return line, launches, rounds, tiered


def phase_kv_tier_worker(card: str, rounds, want) -> tuple:
    """The worker with ``WORKER_TIER_ARGS`` serves both rounds over HTTP
    (in :func:`tier_worker_rounds`' waves): round-2 replies equal the tiered
    engine's tokens, ``/v1/stats`` shows promoted pages and tier hits,
    and no ``kv_tier_fallback`` or ``error`` event appears."""
    import shutil
    disk = Path(__file__).resolve().parent / "build" / "kv_tier_worker"
    shutil.rmtree(disk, ignore_errors=True)
    extra = [a.format(disk=disk) for a in WORKER_TIER_ARGS]
    bodies = tier_worker_rounds(rounds)
    try:
        line, launches, replies, _ = phase_worker(
            card, "worker_kv_tiers", extra, "PagedServer",
            ("flash_decode_paged",), forbid=("paged_fallback",
                                             "kv_tier_fallback"),
            rounds=bodies)
    finally:
        shutil.rmtree(disk, ignore_errors=True)
    n = len(rounds[0])
    got2 = replies[n:]
    want2 = [want[1][r["request_id"]] for r in reversed(rounds[1])]
    problems = [f"round 2 request {i}" for i, (g, w) in
                enumerate(zip(got2, want2)) if g != w]
    window = line["worker_kv_tiers"]["stats_window"]
    if window.get("kv_tier_promoted", 0) < 1 or \
            window.get("kv_tier_hits", 0) < 1:
        problems.append(f"/v1/stats {window}")
    if problems:
        raise RuntimeError("kv tier worker: replies differ from the tiered "
                           "engine's or no promote: " + "; ".join(problems))
    return line, launches


# --------------------------------------------------------------- phase 12

# the prefill tier: a 64-page pool (the worker's --pages 64); the decode
# tier: phase 3's geometry, default pages (slots x max_seq / page_size)
DISAGG_PREFILL = dict(pages=64, page_size=64, prefill_chunk=64)
DISAGG_DECODE = dict(slots=8, page_size=64, prefill_chunk=64)
DISAGG_WINDOW = 8
# the graph check: phase 3's first 8 prompts adopted with this budget
DISAGG_GRAPH_NEW, DISAGG_GRAPH_WINDOWS = 200, 3
# requests the dead-peer coordinator serves co-located
DISAGG_FALLBACK_REQUESTS = ("r0", "prefix-a")
WORKER_DISAGG_ARGS = ("--pages", "64")
KERNEL_COUNTERS = ("flash_decode_paged", "flash_decode",
                   "flash_attention_fwd")


def _launch_counts() -> dict:
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    return {"flash_decode_paged": fd.flash_decode_paged.launches,
            "flash_decode": fd.flash_decode.launches,
            "flash_attention_fwd": fa.flash_attention_fwd.launches}


def _zero_launches() -> None:
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd
    for kern in (fd.flash_decode_paged, fd.flash_decode,
                 fa.flash_attention_fwd):
        kern.launches = 0


def _closed_port() -> int:
    """A localhost port nothing listens on (bound, then released)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ShipTimes:
    """Milliseconds of each part of a shipment, keyed by the prompt:
    ``prefill_ms`` and ``gather_ms`` on the prefill tier, ``pack_ms``,
    ``fetch_ms`` (the decode tier's whole ``KVShipper.fetch``),
    ``unpack_ms``, ``install_ms`` on the decode tier, ``frame_bytes``."""

    def __init__(self):
        self.ms, self._lock = {}, threading.Lock()

    def add(self, prompt, **parts) -> None:
        with self._lock:
            self.ms.setdefault(tuple(prompt), {}).update(parts)

    def split(self, prompt) -> dict:
        """One shipment's parts; ``wire_ms`` is the fetch less the prefill
        tier's work and the unpack: the HTTP transfer and any wait for
        the prefill tier's engine lock."""
        t = dict(self.ms.get(tuple(prompt), {}))
        if "fetch_ms" in t:
            t["wire_ms"] = t["fetch_ms"] - sum(t.get(k, 0.0) for k in (
                "prefill_ms", "gather_ms", "pack_ms", "unpack_ms"))
        return t


def disagg_tiers(cfg, params, dev, times: ShipTimes):
    """The pair's engines and shipper, each timing its part of a
    shipment into ``times`` around the port's own code: a prefill tier
    (``DISAGG_PREFILL``), a decode tier (``DISAGG_DECODE``) that holds
    every page an adoption installs, and the radix pages it shares,
    against the span it adopted (counted in ``checked``, differing ones
    in ``mismatched``), and a ``KVShipper``. The prefill tier's spans and
    the decode tier's window captures never overlap on the card."""
    from dcos_commons_tpu_torch.models import disagg, serving

    # both tiers in one process: a decode window captured while the
    # prefill tier works on the card from its HTTP thread is invalidated
    # (cudaErrorStreamCaptureInvalidated), so a span's prefill and a
    # window's capture take one lock
    card_lock = threading.Lock()

    class Prefill(serving.PagedServer):
        def prefill_span(self, prompt, trace=None):
            with card_lock:
                self.gather_ms = 0.0
                _sync(dev)
                t0 = time.perf_counter()
                span = super().prefill_span(prompt, trace)
                total = (time.perf_counter() - t0) * 1e3
            if span is not None:
                times.add(prompt, prefill_ms=total - self.gather_ms,
                          gather_ms=self.gather_ms)
            return span

        def _gather_span(self, pages):
            _sync(dev)
            t0 = time.perf_counter()
            out = super()._gather_span(pages)
            self.gather_ms += (time.perf_counter() - t0) * 1e3
            return out

    class Decode(serving.PagedServer):
        def __init__(self):
            super().__init__(cfg, params, device=dev, **DISAGG_DECODE)
            self.checked, self.mismatched, self.install_ms = 0, [], 0.0

        def _capture(self, key, fn):
            with card_lock:
                return super()._capture(key, fn)

        def _install(self, payload, a, b, phys):
            _sync(dev)
            t0 = time.perf_counter()
            super()._install(payload, a, b, phys)
            _sync(dev)
            self.install_ms = (time.perf_counter() - t0) * 1e3

        def adopt_pages(self, span, max_new=32, request_id=None):
            self.install_ms = 0.0
            slot = super().adopt_pages(span, max_new, request_id)
            if slot is None or self.requests[slot] is None:
                return slot
            times.add(span["prompt"], install_ms=self.install_ms)
            n = -(-len(span["prompt"]) // self.page_size)
            got = self._gather_span(self._stream_pages[slot][:n])
            for j in range(n):
                self.checked += 1
                if not _same_bits(_page_of(got, j),
                                  _page_of(span["payload"], j)):
                    self.mismatched.append((len(span["prompt"]), j))
            return slot

    class Shipper(disagg.KVShipper):
        def fetch(self, peer, prompt, trace=None):
            t0 = time.perf_counter()
            span = super().fetch(peer, prompt, trace)
            times.add(prompt, fetch_ms=(time.perf_counter() - t0) * 1e3)
            return span

    pre = Prefill(cfg, params, device=dev, **DISAGG_PREFILL)
    dec = Decode()
    return pre, dec, Shipper(timeout_s=600.0)


def _timed_wire(times: ShipTimes):
    """Time ``disagg.pack_span`` and ``unpack_span`` (the prefill tier's
    handler and ``KVShipper.fetch`` call them by their module names)
    into ``times``; returns the function that puts them back."""
    from dcos_commons_tpu_torch.models import disagg
    pack, unpack = disagg.pack_span, disagg.unpack_span

    def timed_pack(span):
        t0 = time.perf_counter()
        frame = pack(span)
        times.add(span["prompt"], pack_ms=(time.perf_counter() - t0) * 1e3,
                  frame_bytes=len(frame))
        return frame

    def timed_unpack(data):
        t0 = time.perf_counter()
        span = unpack(data)
        times.add(span["prompt"],
                  unpack_ms=(time.perf_counter() - t0) * 1e3)
        return span

    disagg.pack_span, disagg.unpack_span = timed_pack, timed_unpack

    def restore():
        disagg.pack_span, disagg.unpack_span = pack, unpack
    return restore


def _serve_over_http(port, reqs, streamed=()) -> tuple:
    """``reqs`` sent at once to ``POST /v1/generate`` (the indices in
    ``streamed`` streamed): (replies, errors, wall s)."""
    replies, errors = [None] * len(reqs), []

    def hit(i):
        try:
            replies[i] = _http_generate(port, {
                "prompt": reqs[i]["prompt"], "max_new": reqs[i]["max_new"],
                "stream": i in streamed})
        except urllib.error.HTTPError as e:
            errors.append(f"request {i}: HTTP {e.code} {e.read()[:300]!r}")
        except Exception as e:            # reported with the other checks
            errors.append(f"request {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return replies, errors, time.perf_counter() - t0


def _held_to(name, got, want, prompts, cfg, params, problems) -> list:
    """Streams of ``got`` equal to ``want`` (both {request: tokens}), or,
    where one differs, every token at a near-tie of the target
    (:func:`stream_check`); returns the divergences."""
    differ = {rid for rid in want if got.get(rid) != want[rid]}
    if not differ:
        return []
    try:
        return stream_check(name, {r: got.get(r) for r in differ},
                            {r: want[r] for r in differ}, prompts, cfg,
                            params)
    except RuntimeError as e:
        problems.append(str(e))
        return []


def phase_disagg(card: str, params, solo, cfg=None, dev=None) -> tuple:
    """Disaggregated prefill/decode serving on phase 3's weights, both
    tiers on one card over the same ``params``: a prefill tier
    (``DISAGG_PREFILL``) behind ``PrefillWorker`` on 127.0.0.1, and a
    decode tier with phase 3's geometry, after ``warmup()``, behind
    ``ServingFrontend(drive=False)`` and ``DisaggCoordinator(decode_window
    =8)``; the decode tier captures its windows at first use, never
    while the prefill tier works (:func:`disagg_tiers`). Phase 3's 12 requests go to ``POST /v1/generate`` at once, two
    streamed: every reply is phase 3's engine stream (or leaves it only at
    a near-tie), every page an adoption installed or shared is bitwise
    the span's, the tensors the graphs bind still the engine's (pool,
    lengths, tokens, table), 12 spans shipped with no fallback, both
    ledgers clean,
    kernel 1 launched by the decode tier and no kernel by the prefill
    tier. Then, serially through the prefill tier's HTTP, 8 prompts
    adopted with 200 new tokens each: graphed windows over the adopted
    streams equal the eager loop bitwise (and the ship split without
    contention); then a coordinator whose only peer is a closed port
    serves 2 requests co-located with their tokens. ``cfg``/``dev``
    default to Llama-3-8B on the card (a smaller model on the CPU
    rehearses the control flow)."""
    import hashlib
    import torch
    from dcos_commons_tpu_torch.models import disagg, llama
    from dcos_commons_tpu_torch.models.ingress import ServingFrontend

    dev = dev or torch.device("cuda")
    cfg = cfg or llama.LlamaConfig.llama3_8b(max_seq=2048)
    queue = solo["queue"]
    want = solo["out"]
    prompts = {r["request_id"]: r["prompt"] for r in queue}
    rid_of = {tuple(r["prompt"]): r["request_id"] for r in queue}
    problems, t_phase = [], time.perf_counter()
    # a device fault left by an earlier phase surfaces here, not in the
    # decode tier's first capture; any thread still running is named
    _sync(dev)
    log(f"[disagg] card clean at the start; threads "
        f"{sorted(t.name for t in threading.enumerate())}")
    times = ShipTimes()
    restore = _timed_wire(times)
    try:
        pre, dec, shipper = disagg_tiers(cfg, params, dev, times)
        warm = dec.warmup()
        # the tensors the captured windows bind, held (so their memory
        # cannot go to a pool an adoption might allocate in their place)
        # and checked to be the engine's own after every stage
        bound = {"pool": dict(dec.pool), "lengths": dec.lengths,
                 "cur_tok": dec.cur_tok, "table": dec._table_buf}

        def rebound(stage):
            now = {"pool": dec.pool, "lengths": dec.lengths,
                   "cur_tok": dec.cur_tok, "table": dec._table_buf}
            moved = [k for k, t in bound.items() if (
                any(now[k][s] is not t[s] for s in t) if k == "pool"
                else now[k] is not t)]
            if moved:
                problems.append(f"{stage}: the decode tier rebound "
                                f"{moved}")
        worker = disagg.PrefillWorker(pre, port=0,
                                      host="127.0.0.1").start()
        peer = f"http://127.0.0.1:{worker.port}"
        fe = ServingFrontend(dec, port=0, host="127.0.0.1",
                             decode_window=DISAGG_WINDOW).start(drive=False)
        coord = disagg.DisaggCoordinator(dec, fe, peer, shipper=shipper,
                                         decode_window=DISAGG_WINDOW)
        _zero_launches()
        coord.start()
        try:
            replies, errors, wall = _serve_over_http(fe.port, queue,
                                                     STREAMED)
            launches = _launch_counts()
            stats, health = coord.stats(), fe.health()
            graphs_during = _graph_line(dec)
        finally:
            coord.stop()
            fe.stop()
        problems += errors
        rebound("concurrent run")
        got = {r["request_id"]: (replies[i] or {}).get("tokens")
               for i, r in enumerate(queue)}
        divergences = _held_to("disagg", got, want, prompts, cfg, params,
                               problems)
        if stats["spans_shipped"] != len(queue) or stats["peer_fallbacks"]:
            problems.append(f"coordinator stats {stats}")
        if dec.adopted_spans != len(queue) or dec.checked < 1:
            problems.append(f"{dec.adopted_spans} adopted, {dec.checked} "
                            f"pages checked, {len(dec.mismatched)} differ "
                            f"from their span: {dec.mismatched[:4]}")
        for name, eng in (("prefill", pre), ("decode", dec)):
            if eng.ledger_violations():
                problems.append(f"{name} ledger "
                                f"{eng.ledger_violations()[:3]}")
        if not health["ok"]:
            problems.append(f"decode front door health {health}")
        if dev.type == "cuda" and launches["flash_decode_paged"] < 1:
            problems.append("flash_decode_paged never launched by the "
                            "decode tier")
        concurrent = {rid_of[k]: times.split(k) for k in times.ms}
        ttft_pair = {r["request_id"]: (replies[i] or {}).get("ttft_ms")
                     for i, r in enumerate(queue)}
        # the prefill tier alone: one span, every kernel count unchanged
        _zero_launches()
        pre.prefill_span(queue[1]["prompt"])
        _sync(dev)
        prefill_launches = _launch_counts()
        if any(prefill_launches.values()):
            problems.append(f"the prefill tier launched {prefill_launches}")
        # serially, without contention: 8 prompts shipped through the
        # prefill tier's HTTP and adopted, then graphed vs eager
        pre.reset()
        dec.reset()
        times.ms.clear()
        for r in queue[:8]:
            slot = dec.adopt_pages(shipper.fetch(peer, r["prompt"]),
                                   max_new=DISAGG_GRAPH_NEW,
                                   request_id=("graph", r["request_id"]))
            if slot is None:
                problems.append(f"graph check: {r['request_id']} found no "
                                "room")
        serial = {rid_of[k]: times.split(k) for k in times.ms}
        try:
            graph = _graph_vs_eager(dec, windows=DISAGG_GRAPH_WINDOWS,
                                    k=DISAGG_WINDOW)
        except RuntimeError as e:
            problems.append(f"over adopted streams: {e}")
            graph = {}
        rebound("serial adoptions")
        if dec.mismatched:
            problems.append(f"{len(dec.mismatched)} adopted pages differ "
                            f"from their span: {dec.mismatched[:4]}")
        dec.reset()
        worker.stop()
        # a dead peer: every request degrades to the co-located path
        fb_reqs = [r for r in queue
                   if r["request_id"] in DISAGG_FALLBACK_REQUESTS]
        fe = ServingFrontend(dec, port=0, host="127.0.0.1",
                             decode_window=DISAGG_WINDOW).start(drive=False)
        coord = disagg.DisaggCoordinator(
            dec, fe, f"http://127.0.0.1:{_closed_port()}",
            shipper=disagg.KVShipper(timeout_s=10.0),
            decode_window=DISAGG_WINDOW).start()
        try:
            fb_replies, fb_errors, _ = _serve_over_http(fe.port, fb_reqs)
            fb_stats = coord.stats()
        finally:
            coord.stop()
            fe.stop()
        problems += fb_errors
        fb_got = {r["request_id"]: (fb_replies[i] or {}).get("tokens")
                  for i, r in enumerate(fb_reqs)}
        fb_div = _held_to("disagg fallback", fb_got,
                          {rid: want[rid] for rid in fb_got}, prompts, cfg,
                          params, problems)
        if fb_stats["peer_fallbacks"] != len(fb_reqs) \
                or fb_stats["spans_shipped"]:
            problems.append(f"dead-peer coordinator stats {fb_stats}")
        if dec.ledger_violations():
            problems.append(f"decode ledger after the fallback "
                            f"{dec.ledger_violations()[:3]}")
        # blake2s over one 8 MiB page: pack and unpack each hash a span
        page = bytes(cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 64 * 2
                     * 2)
        t0 = time.perf_counter()
        for _ in range(5):
            hashlib.blake2s(page).hexdigest()
        blake_ms = (time.perf_counter() - t0) / 5 * 1e3
        page_bytes = len(page)
        checked = dec.checked
        del pre, dec
        gc.collect()
    finally:
        restore()
    if problems:
        raise RuntimeError("disagg phase: " + "; ".join(problems[:8]))
    ttft_colocated = {rid: s * 1e3 for rid, s in solo.get("ttft", {}).items()}

    columns = ("prompt_tokens", "pages", "ttft_ms_pair",
               "ttft_ms_colocated_phase3", "prefill_ms", "gather_ms",
               "pack_ms", "wire_ms", "unpack_ms", "install_ms",
               "frame_bytes", "blake2s_share_of_ship")

    def per_request(split):
        """{"columns": [...], request: [one value a column]}; the ship is
        everything but the prefill, and pack and unpack each hash every
        page once."""
        out = {"columns": list(columns)}
        for rid, t in split.items():
            n = len(prompts[rid])
            pages = -(-n // 64)
            ship = sum(t.get(k, 0.0) for k in (
                "gather_ms", "pack_ms", "wire_ms", "unpack_ms",
                "install_ms"))
            row = {"prompt_tokens": n, "pages": pages,
                   "ttft_ms_pair": ttft_pair.get(rid),
                   "ttft_ms_colocated_phase3": ttft_colocated.get(rid),
                   "blake2s_share_of_ship": 2 * pages * blake_ms
                   / max(ship, 1e-9), **t}
            out[rid] = [row.get(c) for c in columns]
        return out

    def totals(split):
        keys = ("prefill_ms", "gather_ms", "pack_ms", "wire_ms",
                "unpack_ms", "install_ms", "fetch_ms", "frame_bytes")
        return {k: sum(t.get(k, 0.0) for t in split.values()) for k in keys}

    serial_tot = totals(serial)
    serial_pages = sum(-(-len(prompts[rid]) // 64) for rid in serial)
    pair = sorted(v for v in ttft_pair.values() if v is not None)
    colo = sorted(ttft_colocated.values())
    line = {"disagg": {
        "model": "llama3_8b" if cfg.n_layers == 32 else "rehearsal",
        "layers": cfg.n_layers, "max_seq": cfg.max_seq,
        "prefill_tier": DISAGG_PREFILL, "decode_tier": DISAGG_DECODE,
        "decode_window": DISAGG_WINDOW, "requests": len(queue),
        "streamed": len(STREAMED),
        "prompt_tokens": sum(len(p) for p in prompts.values()),
        "pages_shipped": sum(-(-len(p) // 64) for p in prompts.values()),
        "wall_s": wall, "warmup_s": warm,
        "spans_shipped": stats["spans_shipped"],
        "kv_bytes_shipped": stats["kv_bytes_shipped"],
        "peer_fallbacks": stats["peer_fallbacks"],
        "transfer_stalls": stats["transfer_stalls"],
        "iterations": stats["iterations"],
        "checked_pages": checked,
        "near_tie_divergences": divergences,
        "ttft_p50_ms_pair": pair[len(pair) // 2] if pair else None,
        "ttft_p50_ms_colocated_phase3": colo[len(colo) // 2] if colo
        else None,
        "per_request_concurrent": per_request(concurrent),
        "per_request_serial": per_request(serial),
        "serial_ms_per_page": {k: v / serial_pages for k, v in
                               serial_tot.items() if k.endswith("_ms")},
        "blake2s_ms_per_page": blake_ms, "page_bytes": page_bytes,
        "launches_decode_tier": launches,
        "launches_prefill_span_alone": prefill_launches,
        "graphs_during": graphs_during,
        "graph_vs_eager_adopted": {k: graph.get(k) for k in (
            "batch", "windows", "k", "tokens_equal", "kv_bitwise_equal",
            "graph_step_ms", "eager_step_ms", "graphs_captured_here")},
        "fallback": {"requests": len(fb_reqs), **fb_stats,
                     "near_tie_divergences": fb_div},
        "phase_s": time.perf_counter() - t_phase, "card": card}}
    log(f"[disagg] {line}")
    return line, launches["flash_decode_paged"]


def phase_disagg_worker(card: str, want_replies, params) -> tuple:
    """The pair as the scheduler starts it (``dist/disagg.yml``): a
    prefill worker (``WORKER_ARGS`` + ``--pages 64 --serve-role prefill
    --serve-port P``) and, once it serves, a decode worker pointed at it
    (``--serve-role decode --serve-peer http://127.0.0.1:P``) through
    :func:`phase_worker`: phase 6's 8 bodies, replies held to phase 6's
    ``--pages 64`` worker's (exactly or at a near-tie), the decode
    heartbeat's ``disagg`` with 8 spans and no fallback, both
    ``/v1/healthz`` ok (the prefill tier's with ``role: prefill``), and
    the prefill process launching no kernel. A ``disagg_fallback`` from
    either process fails the phase; both end with SIGTERM."""
    import signal
    from dcos_commons_tpu_torch.models import llama

    root = Path(__file__).resolve().parent
    cwd = root / "build" / "worker_smoke_prefill"
    cwd.mkdir(parents=True, exist_ok=True)
    port = _closed_port()
    args = [*WORKER_ARGS, *WORKER_DISAGG_ARGS, "--serve-role", "prefill",
            "--serve-port", str(port)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
         *args], cwd=cwd, env=dict(os.environ, PYTHONPATH=str(root)),
        stdout=subprocess.PIPE, text=True)
    event = _event_reader(proc, [], ("disagg_fallback", "paged_fallback"),
                          "prefill worker")
    bodies = worker_bodies()
    pre_serving = {}
    try:
        def ready():
            pre_serving.update(event("serving", WORKER_BOOT_S))

        line, launches, replies, dec_events = phase_worker(
            card, "worker_disagg", (*WORKER_DISAGG_ARGS, "--serve-role",
                                    "decode", "--serve-peer",
                                    f"http://127.0.0.1:{port}"),
            "PagedServer", ("flash_decode_paged",),
            forbid=("paged_fallback", "disagg_fallback"), ready=ready)
        health = _http_get(port, "/v1/healthz")
        beat = event("heartbeat", 60,
                     lambda e: e.get("shipped_spans", 0) >= len(bodies))
    finally:
        rc = _sigterm(proc)
    problems = []
    dec_serving = next(e for e in dec_events if e.get("event") == "serving")
    dec_beat = [e for e in dec_events if e.get("event") == "heartbeat"][-1]
    disagg_st = dec_beat.get("disagg", {})
    if dec_serving.get("role") != "decode" or pre_serving.get("role") \
            != "prefill":
        problems.append(f"roles {dec_serving.get('role')}, "
                        f"{pre_serving.get('role')}")
    if disagg_st.get("spans_shipped") != len(bodies) \
            or disagg_st.get("peer_fallbacks"):
        problems.append(f"decode heartbeat disagg {disagg_st}")
    if not health.get("ok") or health.get("role") != "prefill":
        problems.append(f"prefill /v1/healthz {health}")
    pre_launches = {k: beat.get("launches", {}).get(k, 0)
                    - pre_serving.get("launches", {}).get(k, 0)
                    for k in KERNEL_COUNTERS}
    if any(pre_launches.values()):
        problems.append(f"the prefill worker launched {pre_launches}")
    if rc != -signal.SIGTERM:
        problems.append(f"prefill worker exited {rc} on SIGTERM")
    divergences = _held_to(
        "worker_disagg", dict(enumerate(replies)),
        dict(enumerate(want_replies)),
        {i: b["prompt"] for i, b in enumerate(bodies)},
        llama.LlamaConfig.llama3_8b(max_seq=2048), params, problems)
    if problems:
        raise RuntimeError("worker_disagg phase: " + "; ".join(problems))
    body = line["worker_disagg"]
    body.update({"prefill_command": "python -m dcos_commons_tpu_torch."
                                    "frameworks.worker " + " ".join(args),
                 "prefill_cold_start": pre_serving.get("cold_start"),
                 "prefill_healthz": health,
                 "prefill_heartbeat": {k: beat.get(k) for k in (
                     "shipped_spans", "pages_free", "pages_in_use_peak",
                     "prefix_hits")},
                 "prefill_launches": pre_launches,
                 "prefill_exit_on_sigterm": rc,
                 "disagg": disagg_st, "near_tie_divergences": divergences,
                 "replies_equal_paged_worker": sum(
                     a == b for a, b in zip(replies, want_replies))})
    log(f"[worker_disagg] {line}")
    return line, launches


# --------------------------------------------------------------- phase 13

MIGRATE_ENGINE = dict(slots=8, page_size=64, prefill_chunk=64)
MIGRATE_WINDOW = 8
# the drain point of phase 3's drive (windows of 8, submitting as slots
# free): at least this many streams decoding with at least this many
# tokens, and at least one stream still prefilling. With 8 slots and one
# prefill chunk a step, at most 5 of phase 3's streams decode while one
# still prefills, so the drain of 8 decoding streams is the graph check's
MIGRATE_MIN_DECODING, MIGRATE_MIN_TOKENS = 4, 4
# the graph check: phase 3's first 8 prompts with this budget, each
# decoding when drained, then windows of 8 on the survivor
MIGRATE_GRAPH_NEW, MIGRATE_GRAPH_WINDOWS = 200, 3
MIGRATE_HTTP_REQUEST = "r2"        # the stream shipped over HTTP
MIGRATE_REFUSED_REQUEST = "r4"     # the stream no destination can take
MIGRATE_SAMPLED_NEW = 64           # the adopt_rng stream's budget


class MigrateTimes:
    """Milliseconds of each part of every stream's move: ``gather_ms``
    (victim, D2H) with the pages it gathered, ``pack_ms`` and
    ``frame_bytes``, ``unpack_ms``, ``install_ms`` (survivor, H2D)."""

    def __init__(self):
        self.ms = {}
        self.pages = 0
        self.frames = 0

    def add(self, key, value) -> None:
        self.ms[key] = self.ms.get(key, 0.0) + value

    def per_page(self) -> dict:
        return {k: v / max(self.pages, 1) for k, v in self.ms.items()
                if k.endswith("_ms")}


def migrate_engines(cfg, params, dev, times: MigrateTimes):
    """A victim and a survivor with phase 3's geometry, each timing its
    part of a move into ``times`` around the port's own code. The
    survivor keeps every state it imported (to hold the installed pages
    to the frame's after the drain) and notes any import that rebound a
    tensor the captured windows read."""
    from dcos_commons_tpu_torch.models import serving

    class Victim(serving.PagedServer):
        def _gather_span(self, pages):
            _sync(dev)
            t0 = time.perf_counter()
            out = super()._gather_span(pages)
            times.add("gather_ms", (time.perf_counter() - t0) * 1e3)
            times.pages += len(pages)
            return out

    class Survivor(serving.PagedServer):
        def __init__(self):
            super().__init__(cfg, params, device=dev, **MIGRATE_ENGINE)
            self.imported, self.rebound = [], []

        def bound(self):
            return [self.pool["k"], self.pool["v"], self.lengths,
                    self.cur_tok, self._table_buf]

        def _install(self, payload, a, b, phys):
            _sync(dev)
            t0 = time.perf_counter()
            super()._install(payload, a, b, phys)
            _sync(dev)
            times.add("install_ms", (time.perf_counter() - t0) * 1e3)

        def import_stream(self, state, request_id=None, adopt_rng=False):
            before = self.bound()
            slot = super().import_stream(state, request_id, adopt_rng)
            if any(x is not y for x, y in zip(before, self.bound())):
                self.rebound.append(request_id)
            if slot is not None:
                self.imported.append((slot, state))
            return slot

        def check_imports(self) -> tuple:
            """(pages checked, [(request, page)] differing from the
            frame); forgets the states."""
            checked, bad = 0, []
            for slot, state in self.imported:
                r = self.requests[slot]
                n = -(-(len(state["prompt"]) + len(state["tokens"]) - 1)
                      // self.page_size)
                got = self._gather_span(self._stream_pages[slot][:n])
                for j in range(n):
                    checked += 1
                    if not _same_bits(_page_of(got, j),
                                      _page_of(state["payload"], j)):
                        bad.append((getattr(r, "request_id", slot), j))
            self.imported = []
            return checked, bad

    return Victim(cfg, params, device=dev, **MIGRATE_ENGINE), Survivor()


def _timed_decstate(times: MigrateTimes):
    """Time ``migrate.pack_decstate`` and ``unpack_decstate`` (the
    manager and the receiver call them by their module names) into
    ``times``; returns the function that puts them back."""
    from dcos_commons_tpu_torch.models import migrate
    pack, unpack = migrate.pack_decstate, migrate.unpack_decstate

    def timed_pack(state, **kw):
        t0 = time.perf_counter()
        frame = pack(state, **kw)
        times.add("pack_ms", (time.perf_counter() - t0) * 1e3)
        times.add("frame_bytes", len(frame))
        times.frames += 1
        return frame

    def timed_unpack(data):
        t0 = time.perf_counter()
        state = unpack(data)
        times.add("unpack_ms", (time.perf_counter() - t0) * 1e3)
        return state

    migrate.pack_decstate, migrate.unpack_decstate = timed_pack, timed_unpack

    def restore():
        migrate.pack_decstate, migrate.unpack_decstate = pack, unpack
    return restore


def _decode_until(srv, slot, tokens) -> None:
    """Windows of 8 until the stream in ``slot`` holds ``tokens``."""
    while srv.requests[slot] is not None \
            and len(srv.requests[slot].tokens) < tokens:
        srv.step_many(MIGRATE_WINDOW)


def _prefilling(srv) -> list:
    return [r.request_id for i, r in enumerate(srv.requests)
            if r is not None and srv._prefill_pos[i] < r.prompt_len]


def phase_migrate(card: str, params, solo, cfg=None, dev=None) -> tuple:
    """Live migration on phase 3's weights, one thread driving every
    engine (no capture overlaps another engine's work): a victim and a
    survivor with phase 3's geometry, each after ``warmup()``. Phase 3's
    12 requests run on the victim in windows of 8 until
    ``MIGRATE_MIN_DECODING`` streams decode with ``MIGRATE_MIN_TOKENS``
    tokens or more while one still prefills; then
    ``MigrationManager(ring=HashRing, on_redirect=...)`` drains the victim
    onto the survivor, which takes the requests not yet admitted and
    finishes every stream: each equal to phase 3's or off it only at a
    near-tie, the receipt with ``failed`` 0 and the prefilling stream
    ``resubmitted``, every imported page bitwise its frame's, the bound
    tensors the survivor's own, both ledgers clean. Then 8 streams of 200
    new tokens drained while decoding and graphed windows over them
    bitwise the eager loop; one stream exported, packed and shipped over
    HTTP to a ``MigrateReceiver`` over the survivor; a drain refused by a
    survivor with every slot taken (the victim finishes the stream); and
    a sampled stream moved with ``adopt_rng=True`` continuing the victim's
    own stream in graphed windows. ``cfg``/``dev`` default to Llama-3-8B
    on the card (a smaller model on the CPU rehearses the control
    flow)."""
    import hashlib
    import torch
    from dcos_commons_tpu_torch.models import llama, migrate, router, serving
    from dcos_commons_tpu_torch.ops.sampling import make_sampler

    dev = dev or torch.device("cuda")
    cfg = cfg or llama.LlamaConfig.llama3_8b(max_seq=2048)
    queue = solo["queue"]
    want = solo["out"]
    prompts = {r["request_id"]: r["prompt"] for r in queue}
    by_rid = {r["request_id"]: r for r in queue}
    problems, t_phase = [], time.perf_counter()
    _sync(dev)
    times = MigrateTimes()
    restore = _timed_decstate(times)
    try:
        victim, survivor = migrate_engines(cfg, params, dev, times)
        warm = {"victim": victim.warmup(), "survivor": survivor.warmup()}
        redirects = []
        mgr = migrate.MigrationManager(
            ring=router.HashRing(["victim", "survivor"]),
            page_size=MIGRATE_ENGINE["page_size"],
            on_redirect=lambda src, dst: redirects.append((src, dst)))
        _zero_launches()
        # 1. phase 3's requests on the victim up to the drain point
        pending, windows = [dict(r) for r in queue], 0
        while True:
            placed = victim.submit_many(pending)
            pending = pending[len(placed):]
            decoding = {r.request_id: len(r.tokens) for r in victim.requests
                        if r is not None and len(r.tokens)
                        >= MIGRATE_MIN_TOKENS}
            prefilling = _prefilling(victim)
            if len(decoding) >= MIGRATE_MIN_DECODING and prefilling:
                break
            if not (pending or victim.requests_active()):
                raise RuntimeError("migrate phase: phase 3's drive never "
                                   "reached the drain point")
            victim.step_many(MIGRATE_WINDOW)
            windows += 1
        live = {r.request_id: len(r.tokens) for r in victim.requests
                if r is not None}
        launches_victim = _launch_counts()["flash_decode_paged"]
        t0 = time.perf_counter()
        receipt = mgr.drain(victim, "victim", [("survivor", survivor)])
        drain_s = time.perf_counter() - t0
        got = dict(victim.finished)
        if victim.requests_active():
            problems.append("the victim kept a stream after the drain")
        checked, bad = survivor.check_imports()
        # the requests not admitted yet are the survivor's new traffic
        before = _launch_counts()["flash_decode_paged"]
        got.update(survivor.drain(pending, decode_window=MIGRATE_WINDOW))
        launches_survivor = _launch_counts()["flash_decode_paged"] - before
        # kernel 1 on each main-path piece, counted from 0 just before it
        # and read just after it: the warmups and the eager check windows
        # fall outside every piece
        pieces = {"drain": _launch_counts()["flash_decode_paged"]}
        divergences = _held_to("migrate", got, want, prompts, cfg, params,
                               problems)
        if receipt["failed"] or receipt["resubmitted"] < 1 \
                or receipt["migrated"] < MIGRATE_MIN_DECODING:
            problems.append(f"drain receipt {receipt}")
        if len(redirects) != receipt["migrated"] + receipt["resubmitted"]:
            problems.append(f"{len(redirects)} redirects for {receipt}")
        for name, eng in (("victim", victim), ("survivor", survivor)):
            if eng.ledger_violations():
                problems.append(f"{name} ledger "
                                f"{eng.ledger_violations()[:3]}")
        if dev.type == "cuda" and launches_survivor < 1:
            problems.append("flash_decode_paged never launched on the "
                            "survivor")
        drained_pages, drained_ms = times.pages, dict(times.ms)
        # 2. 8 decoding streams drained, then graphed vs eager windows
        victim.reset()
        survivor.reset()
        _zero_launches()
        for r in queue[:8]:
            victim.submit(r["prompt"], MIGRATE_GRAPH_NEW,
                          request_id=("graph", r["request_id"]))
        while victim._prefill_q or victim._pending_first:
            victim.step()
        victim.step_many(MIGRATE_WINDOW)
        receipt8 = mgr.drain(victim, "victim", [("survivor", survivor)])
        pieces["drain_8_decoding"] = _launch_counts()["flash_decode_paged"]
        if receipt8["migrated"] != 8:
            problems.append(f"8-stream drain receipt {receipt8}")
        checked8, bad8 = survivor.check_imports()
        checked, bad = checked + checked8, bad + bad8
        try:
            graph = _graph_vs_eager(survivor, windows=MIGRATE_GRAPH_WINDOWS,
                                    k=MIGRATE_WINDOW)
        except RuntimeError as e:
            problems.append(f"over imported streams: {e}")
            graph = {}
        pieces["drain_8_decoding"] += graph.get("graph_launches", {}).get(
            "flash_decode_paged", 0)
        victim.reset()
        survivor.reset()
        # 3. one stream over HTTP into a MigrateReceiver
        rid = MIGRATE_HTTP_REQUEST
        recv = migrate.MigrateReceiver(survivor, port=0,
                                       host="127.0.0.1").start()
        imported_before = survivor.migrated_in
        _zero_launches()
        try:
            slot = victim.submit(prompts[rid], 32, request_id=rid)
            _decode_until(victim, slot, 8)
            state = victim.export_stream(slot)
            frame = migrate.pack_decstate(state, tenant="gold",
                                          request_id=rid)
            t0 = time.perf_counter()
            body = migrate.ship_stream(f"http://127.0.0.1:{recv.port}",
                                       frame, timeout_s=600.0)
            http_ms = (time.perf_counter() - t0) * 1e3
            health = _http_get(recv.port, "/v1/healthz")
        finally:
            recv.stop()
        victim.release_stream(slot)
        checked_h, bad_h = survivor.check_imports()
        checked, bad = checked + checked_h, bad + bad_h
        http_got = survivor.drain([], decode_window=MIGRATE_WINDOW)
        pieces["http"] = _launch_counts()["flash_decode_paged"]
        http_div = _held_to("migrate http", {rid: http_got.get(rid)},
                            {rid: want[rid]}, prompts, cfg, params, problems)
        if not body.get("ok") \
                or health.get("migrated_in") != imported_before + 1:
            problems.append(f"receiver answered {body}, healthz {health}")
        # 4. a survivor with every slot taken refuses; the victim goes on
        survivor.reset()
        victim.reset()
        filler = [{"prompt": by_rid[r["request_id"]]["prompt"][:64],
                   "max_new": 400, "request_id": ("fill", i)}
                  for i, r in enumerate(queue[:8])]
        survivor.submit_many(filler)
        while survivor._prefill_q or survivor._pending_first:
            survivor.step()
        rid = MIGRATE_REFUSED_REQUEST
        _zero_launches()
        slot = victim.submit(prompts[rid], 32, request_id=rid)
        _decode_until(victim, slot, 8)
        refused = migrate.MigrationManager(page_size=64).drain(
            victim, "victim", [("survivor", survivor)])
        kept = victim.requests[slot] is not None
        refused_got = victim.drain([], decode_window=MIGRATE_WINDOW)
        pieces["refused"] = _launch_counts()["flash_decode_paged"]
        refused_div = _held_to("migrate refused", {rid: refused_got.get(rid)},
                               {rid: want[rid]}, prompts, cfg, params,
                               problems)
        if refused["failed"] != 1 or not kept:
            problems.append(f"refused drain {refused}, victim kept the "
                            f"stream: {kept}")
        for name, eng in (("victim", victim), ("survivor", survivor)):
            if eng.ledger_violations():
                problems.append(f"{name} ledger after the refusal "
                                f"{eng.ledger_violations()[:3]}")
        rebound = list(survivor.rebound)
        if rebound:
            problems.append(f"imports rebound a bound tensor: {rebound[:4]}")
        mig_stats = mgr.stats()
        per_page, shipped = times.per_page(), dict(
            bytes=times.ms.get("frame_bytes", 0.0), frames=times.frames,
            pages=times.pages)
        del victim, survivor
        gc.collect()
        # 5. a sampled stream with adopt_rng, in graphed windows
        sampler = make_sampler(0.9, top_k=50)

        def sampled(seed):
            return serving.PagedServer(
                cfg, params, sampler=sampler, device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed),
                **MIGRATE_ENGINE)

        sv, sd = sampled(SEED + 13), sampled(SEED + 14)
        sv.warmup()
        sd.warmup()
        gen = sd.generator
        _zero_launches()
        slot = sv.submit(prompts["r0"], MIGRATE_SAMPLED_NEW,
                         request_id="sampled")
        _decode_until(sv, slot, 8)
        state = migrate.unpack_decstate(migrate.pack_decstate(
            sv.export_stream(slot)))
        new = sd.import_stream(state, request_id="sampled", adopt_rng=True)
        same_gen = sd.generator is gen and torch.equal(
            gen.get_state(), sv.generator.get_state())
        # the victim's own continuation is the check, not the path
        pieces["adopt_rng"] = _launch_counts()["flash_decode_paged"]
        want_s, got_s = [], []
        for _ in range(3):
            want_s += sv.step_many(MIGRATE_WINDOW)[slot]
            before = _launch_counts()["flash_decode_paged"]
            got_s += sd.step_many(MIGRATE_WINDOW)[new]
            pieces["adopt_rng"] += (_launch_counts()["flash_decode_paged"]
                                    - before)
        rng_line = {"slot": new, "same_generator": same_gen,
                    "tokens": len(got_s), "equal": got_s == want_s,
                    "graphs": sd.graph_stats()["graphs"]}
        if new != slot or not same_gen or got_s != want_s \
                or (dev.type == "cuda" and rng_line["graphs"] < 1):
            problems.append(f"adopt_rng: {rng_line}, {got_s[:8]} vs "
                            f"{want_s[:8]}")
        del sv, sd
        gc.collect()
        launches = sum(pieces.values())
        if dev.type == "cuda" and not all(pieces.values()):
            problems.append(f"kernel 1 launches by piece {pieces}")
        # blake2s a page: pack and unpack each hash a frame's body once
        page_bytes = cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 64 * 4
        blob = bytes(4 * page_bytes)
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            hashlib.blake2s(blob).hexdigest()
            reps.append((time.perf_counter() - t0) / 4 * 1e3)
        blake_ms = min(reps)
    finally:
        restore()
    if bad:
        problems.append(f"{len(bad)} imported pages differ from their "
                        f"frame: {bad[:4]}")
    if problems:
        raise RuntimeError("migrate phase: " + "; ".join(problems[:8]))
    line = {"migrate": {
        "model": "llama3_8b" if cfg.n_layers == 32 else "rehearsal",
        "layers": cfg.n_layers, "max_seq": cfg.max_seq,
        "engine": MIGRATE_ENGINE, "decode_window": MIGRATE_WINDOW,
        "warmup_s": warm,
        "drain": {"windows_before": windows, "live": live,
                  "prefilling": [str(r) for r in prefilling],
                  "receipt": receipt, "drain_s": drain_s,
                  "pages": drained_pages,
                  "ms_per_page": {k: v / max(drained_pages, 1)
                                  for k, v in drained_ms.items()
                                  if k.endswith("_ms")},
                  "near_tie_divergences": divergences},
        "drain_8_decoding": receipt8,
        "streams_migrated": {"drain": receipt["migrated"],
                             "drain_8_decoding": receipt8["migrated"],
                             "http": 1, "adopt_rng": 1},
        "resubmitted": mig_stats["resubmitted"],
        "failed": {"drains": mig_stats["failed"],
                   "refused_drain": refused["failed"]},
        "bytes_shipped": shipped["bytes"], "frames": shipped["frames"],
        "pages_shipped": shipped["pages"],
        "pause_ms": mig_stats["pause_ms"],
        "ms_per_page": per_page,
        "blake2s_ms_per_page": blake_ms,
        "blake2s_share_of_pack_unpack": 2 * blake_ms / max(
            per_page.get("pack_ms", 0.0) + per_page.get("unpack_ms", 0.0),
            1e-9),
        "checked_pages": checked,
        "graph_vs_eager_imported": {k: graph.get(k) for k in (
            "batch", "windows", "k", "tokens_equal", "kv_bitwise_equal",
            "graph_step_ms", "eager_step_ms", "graphs_captured_here")},
        "http": {"request": MIGRATE_HTTP_REQUEST, "ms": http_ms,
                 "frame_bytes": len(frame), "receiver": body,
                 "near_tie_divergences": http_div},
        "refused": {"request": MIGRATE_REFUSED_REQUEST, **refused,
                    "near_tie_divergences": refused_div},
        "adopt_rng": rng_line,
        "launches_victim_before_drain": launches_victim,
        "launches_survivor": launches_survivor,
        "launches_by_piece": pieces,
        "launches_phase": launches,
        "phase_s": time.perf_counter() - t_phase, "card": card}}
    log(f"[migrate] {line}")
    return line, launches


FLEET_TENANTS, FLEET_TURNS, FLEET_NEW = 4, 3, 16
# the A/B arms' classes: gold admits the traffic (burst 100,000, never
# refilled); free admits a tenant twice, then sheds it. No class sets a
# TTFT SLO, so the A/B reads placement alone: a cold 512-1,024-token
# prompt at 8B (prefill chunks of 64, first-use captures) answers past
# the deployed 500 ms SLO, and the pressure that reads spills tenants
FLEET_CLASSES = "gold:10:0:100000,free:1:0:2"
# the deployed classes (frameworks/jax/scenarios.py TENANT_CLASSES,
# fleet.yml's --tenant-classes), TTFT SLO included: the third arm
DEPLOYED_CLASSES = "gold:10:50:100:500,bronze:1:5:10"
FLEET_RESIZE_STREAMS, FLEET_RESIZE_NEW = 4, 64
# dist/fleet.yml's decode replica (DISAGG_PAGES -1: a slot-equivalent
# pool of 256 pages): with 64 pages the radix's cached prefixes alone
# read as occupancy past the router's 0.85 spill pressure
# the fleet's workers at 8B width with FLEET_LAYERS of the 32 layers
# (``CUT_WORKER``): at 32 the phase took 127-132 s of the script's 1,200,
# at 8 93 s, and placement, radix hits, spills and the resize do not
# need the depth
FLEET_LAYERS = 4
FLEET_WORKER_ARGS = ("--pages", "-1", "--page-size", "64",
                     "--prefill-chunk", "64")


def fleet_traffic(v: int) -> tuple:
    """4 tenants from the seed, each a 512-1,024-token system prompt;
    turns[t][i] is tenant i's turn t (32-128 more tokens, 16 new), and
    ``resize`` one more turn each for the resize (64 new, streamed)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 13)
    systems = [_prompt(rng, int(rng.integers(512, 1025)), v)
               for _ in range(FLEET_TENANTS)]
    turns = [[{"prompt": systems[i] + _prompt(rng, int(rng.integers(
        32, 129)), v), "max_new": FLEET_NEW, "tenant": f"tenant-{i}",
        "qos": "gold"} for i in range(FLEET_TENANTS)]
        for _ in range(FLEET_TURNS)]
    resize = [{"prompt": systems[i] + _prompt(rng, int(rng.integers(
        32, 129)), v), "max_new": FLEET_RESIZE_NEW, "tenant": f"tenant-{i}",
        "qos": "gold", "stream": True} for i in range(FLEET_RESIZE_STREAMS)]
    return turns, resize


def _spawn(args, cwd: Path, launch=WORKER_MODULE):
    root = Path(__file__).resolve().parent
    cwd.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, *launch, *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(root)),
        stdout=subprocess.PIPE, text=True)


def _gpu_pids() -> list:
    """PIDs with a context on the card, as ``nvidia-smi`` lists them
    (empty where the container hides them)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except Exception:
        return []
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _beat_launches(event) -> int:
    return event.get("launches", {}).get("flash_decode_paged", 0)


def _fleet_arm(name: str, policy: str, turns, worker_args,
               classes=FLEET_CLASSES, resize=None,
               launch=WORKER_MODULE) -> dict:
    """One arm: two freshly booted decode workers (cold radixes) and a
    router worker over them with ``policy`` and ``classes``; the turns
    one request at a time through the router. Returns the arm's replies,
    hits, kernel-1 launches of the routed traffic (the heartbeats read
    before and after each routed piece, never across a direct call),
    boot seconds, router stats and, with ``resize``, the shed and resize
    results; every process ends with SIGTERM."""
    root = Path(__file__).resolve().parent / "build" / f"fleet_{name}"
    procs, out = [], {"policy": policy, "classes": classes}
    try:
        t0 = time.perf_counter()
        workers = []
        for i in range(2):
            proc = _spawn([*worker_args, *FLEET_WORKER_ARGS],
                          root / f"worker{i}", launch)
            procs.append(proc)
            events = []
            workers.append((proc, _event_reader(
                proc, events, ("paged_fallback",), f"fleet worker {i}"),
                events))
        serving, boot = [], []
        for proc, event, _ in workers:
            serving.append(event("serving", WORKER_BOOT_S))
            boot.append(time.perf_counter() - t0)
        urls = [f"http://127.0.0.1:{s['port']}" for s in serving]
        t1 = time.perf_counter()
        rproc = _spawn(["llama", "--serve", "--serve-role", "router",
                        "--route-replicas", ",".join(urls),
                        "--route-policy", policy, "--page-size", "64",
                        "--serve-port", "0", "--serve-interval", "2",
                        "--tenant-classes", classes], root / "router")
        procs.append(rproc)
        r_events = []
        r_event = _event_reader(rproc, r_events, ("router_config_error",),
                                "router")
        r_serving = r_event("serving", 120)
        boot.append(time.perf_counter() - t1)
        rport = r_serving["port"]
        replies = []
        for turn in turns:
            for body in turn:
                replies.append(_http_generate(rport, body))
        served = {u: sum(r["replica"] == u for r in replies) for u in urls}
        beats = [event("heartbeat", 60,
                       lambda e, n=served[u]: e.get("requests", 0) >= n)
                 for (proc, event, _), u in zip(workers, urls)]
        launches = [_beat_launches(b) - _beat_launches(s)
                    for b, s in zip(beats, serving)]
        out.update(urls=urls, replies=replies, served=served,
                   hits=[b["paged"]["prefix_hits"] for b in beats],
                   ttft_p95_ms=[_http_get(s["port"], "/v1/healthz")[
                       "load"].get("ttft_p95_ms") for s in serving],
                   boot_s=boot, router_serving=r_serving)
        # every reply equals a direct call to the replica that served it
        direct = [_http_generate(int(r["replica"].rsplit(":", 1)[1]), {
            "prompt": b["prompt"], "max_new": b["max_new"]})["tokens"]
            for r, b in zip(replies, [b for t in turns for b in t])]
        out["direct_equal"] = [r["tokens"] == d
                               for r, d in zip(replies, direct)]
        if resize:
            # a tenant past its bucket gets the reference's 429
            flood = {"prompt": turns[0][0]["prompt"][:64], "max_new": 1,
                     "tenant": "flood", "qos": "free"}
            codes = []
            for _ in range(3):
                try:
                    _http_generate(rport, flood)
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append((e.code, e.headers.get("Retry-After")))
            out["shed"] = codes
            marks = []
            for (proc, event, _), s in zip(workers, serving):
                n = _http_get(s["port"], "/v1/stats")["requests"]
                marks.append(_beat_launches(event(
                    "heartbeat", 60, lambda e, n=n: e.get("requests", 0)
                    >= n)))
            # one replica swapped out and back in under 4 streams
            res, errors = [None] * len(resize), []

            def hit(i):
                try:
                    res[i] = _http_generate(rport, resize[i])
                except Exception as e:     # reported with the checks
                    errors.append(f"resize stream {i}: {e!r}")

            threads = [threading.Thread(target=hit, args=(i,))
                       for i in range(len(resize))]
            for t in threads:
                t.start()
            time.sleep(0.5)
            swaps = [_http_post(rport, "/v1/replicas",
                                {"replicas": urls[1:]}),
                     _http_post(rport, "/v1/replicas", {"replicas": urls})]
            for t in threads:
                t.join(timeout=600)
            for i, ((proc, event, _), s) in enumerate(zip(workers, serving)):
                n = _http_get(s["port"], "/v1/stats")["requests"]
                launches[i] += _beat_launches(event(
                    "heartbeat", 60, lambda e, n=n: e.get("requests", 0)
                    >= n)) - marks[i]
            # each stream ran beside the others; its direct call runs
            # alone: held to it by the near-tie rule
            out["resize"] = {
                "errors": errors, "swaps": swaps,
                "tokens": [len(r["tokens"]) if r else None for r in res],
                "replies": [r["tokens"] if r else None for r in res],
                "direct": [_http_generate(
                    int(r["replica"].rsplit(":", 1)[1]),
                    {"prompt": b["prompt"], "max_new": b["max_new"]}
                )["tokens"] if r else None for r, b in zip(res, resize)]}
        stats = _http_get(rport, "/v1/routestats")
        rbeat = r_event("heartbeat", 60,
                        lambda e: e.get("routed", 0) >= stats["routed"])
        out.update(stats=stats, router_heartbeat_cuda=rbeat.get(
            "cuda_initialized"), gpu_pids=_gpu_pids(), router_pid=rproc.pid,
            launches=launches)
    finally:
        out["exit"] = [_sigterm(p) for p in procs]
    return out


def _http_post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def phase_fleet(card: str, params=None, worker_args=WORKER_ARGS,
                cfg=None, layers=None, dev="cuda") -> tuple:
    """The fleet as ``dist/fleet.yml`` deploys it: two decode workers
    (``worker_args`` + ``FLEET_WORKER_ARGS``, fleet.yml's ``--pages -1
    --page-size 64 --prefill-chunk 64``, Llama-3-8B) and a router worker
    (``--serve-role router --route-replicas ... --page-size 64
    --tenant-classes ...``) in front, in three arms, each on a freshly
    booted pair: ``affinity`` and ``random`` under ``FLEET_CLASSES``,
    and ``slo``, affinity under the deployed ``DEPLOYED_CLASSES`` (a 500
    ms TTFT SLO). 4 tenants x 3 turns (:func:`fleet_traffic`), one
    request at a time: every reply equals a direct call to the replica
    that served it; under affinity each request lands on its ring
    primary unless the router counted it a hot spill, and under
    ``FLEET_CLASSES`` each tenant lands on one replica and the fleet's
    radix hits (``paged.prefix_hits`` in the workers' heartbeats) are
    strictly more than under random; the affinity arm's router sheds a
    tenant past its bucket with 429, and swaps a replica out and back in
    under 4 streams with no stream dropped; the router never initializes
    CUDA, and kernel 1 runs in the decode workers. The resize's streams,
    which ran side by side, are held to their direct calls by the
    near-tie rule over ``params`` (the workers' weights: both from the
    seed; built here from ``cfg`` when None and a stream differs).
    ``cfg`` defaults to Llama-3-8B's width at ``layers`` (default
    ``FLEET_LAYERS``) of its 32 layers, the workers' cut through
    ``CUT_WORKER``; a rehearsal on the CPU passes its own, and ``--device
    cpu`` in ``worker_args``."""
    import signal
    import torch
    from dcos_commons_tpu_torch.models import llama, router
    layers = layers or FLEET_LAYERS
    cfg = cfg or dataclasses.replace(
        llama.LlamaConfig.llama3_8b(max_seq=2048), n_layers=layers)
    launch = ("-c", CUT_WORKER, str(layers))
    args = list(worker_args)
    on_card = not ("--device" in args
                   and args[args.index("--device") + 1] == "cpu")
    turns, resize = fleet_traffic(cfg.vocab_size)
    bodies = [b for t in turns for b in t]
    t_phase = time.perf_counter()
    arms = {"affinity": _fleet_arm("affinity", "affinity", turns,
                                   worker_args, resize=resize,
                                   launch=launch),
            "random": _fleet_arm("random", "random", turns, worker_args,
                                 launch=launch),
            "slo": _fleet_arm("slo", "affinity", turns, worker_args,
                              classes=DEPLOYED_CLASSES, launch=launch)}
    problems = []
    aff, rnd = arms["affinity"], arms["random"]
    for p, arm in arms.items():
        if not all(arm["direct_equal"]):
            problems.append(f"{p}: replies differ from a direct call "
                            f"{arm['direct_equal']}")
        if any(len(r["tokens"]) != FLEET_NEW for r in arm["replies"]):
            problems.append(f"{p}: short replies")
        if arm["router_heartbeat_cuda"] is not False \
                or arm["router_pid"] in arm["gpu_pids"]:
            problems.append(f"{p}: the router touched the card "
                            f"({arm['router_heartbeat_cuda']}, pids "
                            f"{arm['gpu_pids']})")
        if arm["exit"] != [-signal.SIGTERM] * 3:
            problems.append(f"{p}: exits {arm['exit']}")
        if arm["stats"]["dropped_streams"]:
            problems.append(f"{p}: dropped {arm['stats']}")
        # a worker the ring gave no tenant may launch nothing
        if on_card and (sum(arm["launches"]) < 1 or any(
                n < 1 for n, u in zip(arm["launches"], arm["urls"])
                if arm["served"][u])):
            problems.append(f"{p}: kernel 1 launches {arm['launches']} "
                            f"for {arm['served']}")
        if arm["policy"] != "affinity":
            continue
        # on the ring's primary, or a hot spill the router counted
        ring = router.HashRing(arm["urls"])
        off = [(r["replica"], r["routed"]) for r, b in zip(
            arm["replies"], bodies)
            if (r["replica"] == ring.preference(router.route_key(
                b["prompt"], 64))[0]) != (r["routed"] == "affinity")
            or r["routed"] not in ("affinity", "spill_hot")]
        arm["spills_hot"] = sum(r["routed"] == "spill_hot"
                                for r in arm["replies"])
        if off or arm["stats"]["spills_hot"] != arm["spills_hot"]:
            problems.append(f"{p}: routes off the ring {off[:4]}, "
                            f"{arm['spills_hot']} hot spills against "
                            f"{arm['stats']['spills_hot']} counted")
    landed = {}
    for r, b in zip(aff["replies"], bodies):
        landed.setdefault(b["tenant"], set()).add(r["replica"])
    if any(len(s) != 1 for s in landed.values()):
        problems.append(f"affinity spread a tenant: {landed}")
    if sum(aff["hits"]) <= sum(rnd["hits"]):
        problems.append(f"radix hits affinity {aff['hits']} <= random "
                        f"{rnd['hits']}")
    if [c if isinstance(c, int) else c[0] for c in aff["shed"]] \
            != [200, 200, 429] or not aff["shed"][2][1]:
        problems.append(f"shed {aff['shed']}")
    rz = aff["resize"]
    if rz["errors"] or rz["tokens"] != [FLEET_RESIZE_NEW] * len(resize) \
            or aff["stats"]["rebalances"] != 2:
        problems.append(f"resize {rz['errors']}, tokens {rz['tokens']}, "
                        f"rebalances {aff['stats']['rebalances']}")
    got, want = (dict(enumerate(rz.pop(k))) for k in ("replies", "direct"))
    if params is None and got != want:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    resize_div = _held_to(
        "fleet resize", got, want,
        {i: b["prompt"] for i, b in enumerate(resize)}, cfg, params,
        problems)
    if problems:
        raise RuntimeError("fleet phase: " + "; ".join(problems[:8]))

    def summary(arm):
        st = arm["stats"]
        return {"replies": len(arm["replies"]), "served": arm["served"],
                "radix_hits": arm["hits"],
                "radix_hits_total": sum(arm["hits"]),
                "classes": arm["classes"],
                "affinity_rate": st["affinity_rate"],
                "spills_hot": st["spills_hot"],
                "replica_ttft_p95_ms": arm["ttft_p95_ms"],
                "rebalances": st["rebalances"],
                "dropped_streams": st["dropped_streams"],
                "router_ttft_ms": st["ttft_ms"],
                "ttft_p50_ms": st["ttft_ms"].get("p50"),
                "boot_s": {"worker0": arm["boot_s"][0],
                           "worker1": arm["boot_s"][1],
                           "router": arm["boot_s"][2]},
                "launches_per_worker": arm["launches"],
                "direct_equal": sum(arm["direct_equal"]),
                "router_cuda_initialized": arm["router_heartbeat_cuda"]}

    line = {"fleet": {
        "model": (f"llama3_8b width, {cfg.n_layers} of 32 layers"
                  if cfg.dim == 4096 else "rehearsal"),
        "workers": 2,
        "worker_command": "python -m dcos_commons_tpu_torch.frameworks."
                          "worker " + " ".join([*worker_args,
                                                *FLEET_WORKER_ARGS]),
        "router_command": "python -m dcos_commons_tpu_torch.frameworks."
                          "worker llama --serve --serve-role router "
                          "--route-replicas URL,URL --route-policy POLICY "
                          "--page-size 64 --tenant-classes CLASSES",
        "tenants": FLEET_TENANTS, "turns": FLEET_TURNS, "new": FLEET_NEW,
        **{p: summary(arm) for p, arm in arms.items()},
        "shed": aff["shed"],
        "resize": {**rz, "streams": len(resize),
                   "near_tie_divergences": resize_div},
        "phase_s": time.perf_counter() - t_phase, "card": card}}
    log(f"[fleet] {line}")
    return line, sum(sum(arm["launches"]) for arm in arms.values())


# --------------------------------------------------------------- phase 14

# ResNet-50 as the resnet service trains it: frameworks/jax/scenarios.py
# BATCH_PER_HOST and bench.py's RESNET_BATCH, 224x224 bf16
RESNET_DEPTH, RESNET_BATCH, RESNET_SIZE = 50, 256, 224
RESNET_WARMUP, RESNET_STEPS = 3, 20
# bench.py:37's count: forward + backward, 3 x 4.09 GFLOP an image
RESNET_FLOP_PER_IMAGE = 3 * 4.09e9
# card vs CPU, the same port functions in fp32 (TF32 off): logits and
# each batch-norm state leaf within 1e-3 of their largest value, the loss
# within 1e-4; every eval-mode gradient (no batch statistics) within 1e-3
# of the tree's largest (1e-4 before call 2 measured 1.28e-4: without
# batch statistics the init's running ones leave the 16 blocks' sums
# unnormalised); the train-mode gradient's cosine >= 0.999 and
# each element within 5e-2 of the largest: cuDNN and the CPU sum in other
# orders, and the batch statistics amplify that through 16 blocks (call
# 1: 0.0225 and 0.99973, as the CPU tests find against JAX)
RESNET_CHECK_BATCH = 8
RESNET_LOGIT_TOL, RESNET_LOSS_RTOL = 1e-3, 1e-4
RESNET_EVAL_GRAD_TOL = 1e-3     # call 2: 1.28e-4
RESNET_GRAD_TOL, RESNET_GRAD_COSINE = 5e-2, 0.999
RESNET_WORKER_STEPS, RESNET_WORKER_RESUMED = 8, 12
MNIST_STEPS, MNIST_RESUMED = 200, 250
# kernel-name fragments of the convolutions (cuDNN, and the head's
# product); the first family that matches wins
RESNET_FAMILIES = (("convolution", ("conv", "xmma", "implicit", "fprop",
                                    "dgrad", "wgrad", "cudnn", "cutlass",
                                    "gemm", "nvjet", "sm90_", "sm80_")),
                   ("elementwise", ("",)))


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def resnet_grads(cfg, params, state, x, y):
    """(loss, logits, new state, {leaf: gradient}) of one train pass, and
    {leaf: gradient} of the eval-mode loss over ``state``."""
    import torch
    from dcos_commons_tpu_torch.models import resnet, train
    from dcos_commons_tpu_torch.ops.losses import softmax_cross_entropy
    leaves = train._leaves(params)
    names = [k for k, _ in _named(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, (_, new_state) = resnet.loss_fn(cfg, params, state, (x, y))
        grads = torch.autograd.grad(loss, leaves)
        eval_loss = softmax_cross_entropy(
            resnet.forward(cfg, params, state, x, train=False)[0], y)[0]
        eval_grads = torch.autograd.grad(eval_loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    with torch.no_grad():
        logits, _ = resnet.forward(cfg, params, state, x)
    return (loss.detach(), logits, train._detached(new_state),
            dict(zip(names, grads)), dict(zip(names, eval_grads)))


def resnet_card_vs_cpu(dev, depth=RESNET_DEPTH, size=RESNET_SIZE,
                       batch=RESNET_CHECK_BATCH, width=64) -> dict:
    """The fp32 ResNet's train pass on the card and through the same port
    functions on the CPU (which the tier-1 tests hold to JAX), on the same
    init and batch: logits, loss, new batch-norm state and every gradient
    of the train-mode and of the eval-mode loss."""
    import numpy as np
    import torch
    from dcos_commons_tpu_torch.models import resnet
    cfg = resnet.ResNetConfig(depth=depth, n_classes=1000, width=width,
                              dtype=torch.float32)
    params, state = resnet.init_params(
        cfg, torch.Generator().manual_seed(SEED), device="cpu")
    rng = np.random.default_rng(SEED + 14)
    x = torch.from_numpy(rng.standard_normal(
        (batch, size, size, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, (batch,)).astype(np.int32))
    t0 = time.perf_counter()
    want = resnet_grads(cfg, params, state, x, y)
    cpu_s = time.perf_counter() - t0
    got = resnet_grads(cfg, _tree_to(params, dev), _tree_to(state, dev),
                       x.to(dev), y.to(dev))
    loss_w, logits_w, state_w, grads_w, eval_w = want
    loss_g, logits_g, state_g, grads_g, eval_g = [
        _tree_to(t, "cpu") if isinstance(t, dict) else t.cpu() for t in got]
    out = {"depth": depth, "batch": batch, "size": size, "cpu_s": cpu_s}
    out["logits_err"] = float((logits_g - logits_w).abs().max()
                              / logits_w.abs().max())
    out["loss_rel_err"] = abs(float(loss_g) / float(loss_w) - 1)
    out["state_err"] = max(
        float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        for (_, a), (_, b) in zip(_named(state_g), _named(state_w)))
    scale = max(float(g.abs().max()) for g in grads_w.values())
    out["grad_err"] = max(float((grads_g[k] - g).abs().max())
                          for k, g in grads_w.items()) / scale
    a = torch.cat([g.flatten() for g in grads_w.values()]).double()
    b = torch.cat([grads_g[k].flatten() for k in grads_w]).double()
    out["grad_cosine"] = float(a @ b / (a.norm() * b.norm()))
    scale = max(float(g.abs().max()) for g in eval_w.values())
    out["eval_grad_err"] = max(float((eval_g[k] - g).abs().max())
                               for k, g in eval_w.items()) / scale
    problems = []
    if out["logits_err"] > RESNET_LOGIT_TOL:
        problems.append(f"logits {out['logits_err']}")
    if out["loss_rel_err"] > RESNET_LOSS_RTOL:
        problems.append(f"loss {out['loss_rel_err']}")
    if out["state_err"] > RESNET_LOGIT_TOL:
        problems.append(f"batch-norm state {out['state_err']}")
    if out["grad_err"] > RESNET_GRAD_TOL \
            or out["grad_cosine"] < RESNET_GRAD_COSINE:
        problems.append(f"gradients {out['grad_err']}, cosine "
                        f"{out['grad_cosine']}")
    if out["eval_grad_err"] > RESNET_EVAL_GRAD_TOL:
        problems.append(f"eval-mode gradients {out['eval_grad_err']}")
    if problems:
        raise RuntimeError("resnet card vs CPU: " + "; ".join(problems))
    return out


def _resnet_family(name: str) -> str:
    low = name.lower()
    return next(fam for fam, keys in RESNET_FAMILIES
                if any(k in low for k in keys))


def resnet_split(step, opt, params, opt_state, state, batch) -> dict:
    """One train step split on the device: forward, backward and the
    optimizer by CUDA events around the step's own parts (two steps), then
    one step under ``torch.profiler``: device busy time, the idle share,
    and the kernels' time by family (convolutions, the batch-norm and
    other elementwise passes, the optimizer's update)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dcos_commons_tpu_torch.models import resnet, train
    from tools.torch_profile_decode import _device_us

    cfg, x, y = batch
    leaves = train._leaves(params)
    phase_ms = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for t in leaves:
            t.requires_grad_(True)
        ev[0].record()
        loss, (_, state) = resnet.loss_fn(cfg, params, state, (x, y))
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        for t in leaves:
            t.requires_grad_(False)
        train.apply_updates(opt, params, list(grads), opt_state)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(phase_ms):
            phase_ms[name] += ev[i].elapsed_time(ev[i + 1]) / 2
        state = train._detached(state)
        del grads, loss
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, (state, (x, y)))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the step's record_function ranges also come back as device-side
    # spans: they are read as ranges, not summed with the kernels
    ranges = {e.key: _device_us(e) / 1e3 for e in prof.key_averages()
              if e.key.startswith("train_step.")}
    events = [e for e in prof.key_averages()
              if not e.key.startswith("train_step.")]
    busy = sum(_device_us(e) for e in events) / 1e3
    fam = {name: 0.0 for name, _ in RESNET_FAMILIES}
    for e in events:
        fam[_resnet_family(e.key)] += _device_us(e) / 1e3
    opt_ms = ranges.get("train_step.optimizer", 0.0)
    top = sorted(events, key=_device_us, reverse=True)[:10]
    return {"phase_ms_events": phase_ms, "wall_ms_profiled": wall_ms,
            "range_spans_ms": ranges,
            "device_busy_ms": busy or None,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ms": {"convolution": fam["convolution"],
                          "optimizer_span": opt_ms or None,
                          "batch_norm_elementwise_and_optimizer":
                              fam["elementwise"]} if busy else None,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms": _device_us(e) / 1e3}
                           for e in top if _device_us(e)]}


def phase_resnet(card: str, dev="cuda", depth=RESNET_DEPTH,
                 batch=RESNET_BATCH, size=RESNET_SIZE, steps=RESNET_STEPS,
                 check=None) -> dict:
    """ResNet-50 at full width and depth, bf16, as the ``resnet`` service
    trains it: first the fp32 train pass held card against CPU
    (:func:`resnet_card_vs_cpu`, or ``check``), then, with
    ``cudnn.benchmark`` on as in the worker, ``RESNET_WARMUP`` warm-up and
    ``steps`` timed steps on one fixed synthetic batch
    (``make_optimizer(lr=0.1)``, the ``has_aux_state`` step): step ms,
    images/s, MFU against the bf16 peak by bench.py's FLOP count, peak
    device memory, the loss stream (finite), and one step's device split
    (:func:`resnet_split`)."""
    import math
    import torch
    from dcos_commons_tpu_torch.models import resnet, train
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    parity = (check if check is not None else resnet_card_vs_cpu)(dev)
    parity_s = time.perf_counter() - t0
    cfg = resnet.ResNetConfig(depth=depth, n_classes=1000)
    # as the worker's resnet: cuDNN picks each conv's algorithm by timing
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = on_card
    gen = torch.Generator(device=dev)
    params, state = resnet.init_params(cfg, gen.manual_seed(SEED),
                                       device=dev)
    opt = train.make_optimizer(lr=0.1)
    step = train.make_train_step(
        lambda p, b: resnet.loss_fn(cfg, p, b[0], b[1]), opt,
        has_aux_state=True)
    opt_state = train.init_opt_state(opt, params)
    x = torch.randn((batch, size, size, 3), dtype=torch.bfloat16,
                    generator=gen.manual_seed(SEED + 1), device=dev)
    y = torch.randint(0, 1000, (batch,), dtype=torch.int32,
                      generator=gen.manual_seed(SEED + 100), device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for _ in range(RESNET_WARMUP):
        params, opt_state, state, out = step(params, opt_state,
                                             (state, (x, y)))
        losses.append(out["loss"])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, state, out = step(params, opt_state,
                                             (state, (x, y)))
        losses.append(out["loss"])
    _sync(dev)
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"resnet phase: losses {losses}")
    ips = batch * steps / wall
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    split = (resnet_split(step, opt, params, opt_state, state, (cfg, x, y))
             if on_card else None)
    torch.backends.cudnn.benchmark = benchmark
    line = {"resnet": {
        "model": f"resnet{depth}", "batch": batch, "image": size,
        "dtype": "bf16", "optimizer": "AdamW lr 0.1 (make_optimizer)",
        "card_vs_cpu_fp32": parity, "card_vs_cpu_s": parity_s,
        "warmup_steps": RESNET_WARMUP, "steps": steps,
        "step_ms": wall / steps * 1e3, "images_per_sec": ips,
        "flop_per_image": RESNET_FLOP_PER_IMAGE,
        "flop_count": "bench.py:37, 3 x 4.09 GFLOP an image",
        "mfu": ips * RESNET_FLOP_PER_IMAGE / BF16_OPS_PER_S,
        "peak_mem_gb": peak, "losses": losses, "split": split,
        "card": card}}
    log(f"[resnet] {line}")
    return line


def phase_resnet_worker(card: str, depth=RESNET_DEPTH, batch=RESNET_BATCH,
                        steps=RESNET_WORKER_STEPS,
                        resumed=RESNET_WORKER_RESUMED,
                        mnist=(MNIST_STEPS, MNIST_RESUMED),
                        extra=()) -> dict:
    """The worker's ``resnet --depth 50 --batch 256 --steps 8 --out VOL``
    (Adam count 9 saved at step 8: the warm-up's update is kept), its
    relaunch with ``--steps 12`` (``resumed`` at 8, 4 steps, count 13),
    and beside them (:func:`_side_by_side`) ``mnist --steps 200 --out
    VOL2`` and its relaunch with ``--steps 250`` (``resumed`` at 200, 50
    steps)."""
    import math
    import shutil
    base = Path(__file__).resolve().parent / "build" / "resnet_smoke"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    vol, vol2 = base / "vol", base / "vol2"
    problems, runs = [], {}

    def run(name, args):
        t0 = time.perf_counter()
        rc, events = _worker_run([*args, *extra], base)
        done = [e for e in events if e.get("event") == "done"]
        runs[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                      "resumed": [e["step"] for e in events
                                  if e.get("event") == "resumed"],
                      "done": done[0] if done else None}
        if rc != 0 or not done:
            problems.append(f"{name}: exit {rc}, {events[-2:]}")
            return {}
        return done[0]

    def resnet_chain():
        rn = ["resnet", "--depth", str(depth), "--batch", str(batch)]
        done = run("resnet", [*rn, "--steps", str(steps), "--out",
                              str(vol)])
        if done and (done["steps"] != steps
                     or not math.isfinite(done["final_loss"] or math.nan)
                     or _saved_counts(vol, steps) != (steps + 1,) * 2):
            problems.append(f"resnet: {done}, counts "
                            f"{_saved_counts(vol, steps)}")
        done = run("resnet_resumed", [*rn, "--steps", str(resumed), "--out",
                                      str(vol)])
        if done and (runs["resnet_resumed"]["resumed"] != [steps]
                     or done["steps"] != resumed - steps
                     or _saved_counts(vol, resumed) != (resumed + 1,) * 2):
            problems.append(f"resnet_resumed: {runs['resnet_resumed']}")

    m_steps, m_resumed = mnist

    def mnist_chain():
        done = run("mnist", ["mnist", "--steps", str(m_steps), "--out",
                             str(vol2)])
        if done and (done["steps"] != m_steps
                     or not math.isfinite(done["final_loss"])):
            problems.append(f"mnist: {done}")
        done = run("mnist_resumed", ["mnist", "--steps", str(m_resumed),
                                     "--out", str(vol2)])
        if done and (runs["mnist_resumed"]["resumed"] != [m_steps]
                     or done["steps"] != m_resumed - m_steps):
            problems.append(f"mnist_resumed: {runs['mnist_resumed']}")

    _side_by_side(resnet_chain, mnist_chain)
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("resnet worker phase: " + "; ".join(problems))
    line = {"worker_resnet": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   f"resnet --depth {depth} --batch {batch} --steps "
                   f"{steps} --out VOL, then --steps {resumed}; mnist "
                   f"--steps {m_steps} --out VOL2, then --steps {m_resumed}",
        "runs": runs, "card": card}}
    log(f"[worker_resnet] {line}")
    return line


# phase 14b at 8B width with PEER_LAYERS of the 32 layers: at full depth
# the phase took 485 s (seed save 90 s, fetch 276 s, restore 75 s of 16.06
# GB), past what the script's 1,200 s allow beside the other phases; at 8
# layers 91-94 s, at 4 73-91 s (its disk and hashing time varies most
# from machine to machine), cut to 2 to keep the script with phase 15
# under 1,100 s. The worker has no layer
# knob; this launcher cuts its 8b preset in the worker's own process and
# runs the worker's main.
PEER_LAYERS = 2
CUT_WORKER = (
    "import dataclasses, sys\n"
    "from dcos_commons_tpu_torch.models import llama\n"
    "full = llama.LlamaConfig.llama3_8b\n"
    "n = int(sys.argv.pop(1))\n"
    "llama.LlamaConfig.llama3_8b = staticmethod(\n"
    "    lambda **kw: dataclasses.replace(full(**kw), n_layers=n))\n"
    "from dcos_commons_tpu_torch.frameworks import worker\n"
    "sys.exit(worker.main(sys.argv[1:]))\n")


def phase_peer_boot(card: str, worker_args=WORKER_ARGS,
                    layers=PEER_LAYERS, dev="cuda", cfg=None) -> tuple:
    """Scale-up through the weight server, as ``dist/llama.yml``'s decode
    tier boots a sibling, at 8B width with ``layers`` layers
    (``CUT_WORKER``): worker A (``WORKER_ARGS --pages 64 --out VOL_A`` with
    ``WEIGHT_SERVE_PORT``) boots from the init, seeds step 0, serves it
    and answers phase 6's 8 requests; worker B (the same with ``--out
    VOL_B`` and ``WEIGHT_FETCH_PEERS`` at A) mirrors A's step into VOL_B,
    restores from it (``source: peer``) and, through
    :func:`phase_worker`, answers the same requests, held to A's replies
    (exactly or at a near-tie of the cut model). VOL_B's committed
    manifest equals VOL_A's and B's restore held every shard to its
    digest, so the step's files are byte-equal. A fetch or restore
    fallback fails the phase. B's kernel-1 launches are counted around its
    requests only. ``cfg`` is the model the workers serve, for the
    near-tie rule (default: the cut 8b preset)."""
    import shutil
    import signal
    import torch
    from dcos_commons_tpu_torch.models import llama

    root = Path(__file__).resolve().parent
    base = root / "build" / "peer_smoke"
    shutil.rmtree(base, ignore_errors=True)
    (base / "a").mkdir(parents=True)
    vol_a, vol_b = base / "a" / "vol", base / "b" / "vol"
    launch = ("-c", CUT_WORKER, str(layers))
    args_a = [*worker_args, "--pages", "64", "--out", str(vol_a)]
    proc = subprocess.Popen(
        [sys.executable, *launch, *args_a], cwd=base / "a",
        env=dict(os.environ, PYTHONPATH=str(root), WEIGHT_SERVE_PORT="0"),
        stdout=subprocess.PIPE, text=True)
    event = _event_reader(proc, [], ("weight_server_error",
                                     "paged_fallback"), "peer worker A")
    bodies = worker_bodies()
    try:
        t0 = time.perf_counter()
        loaded_a = event("weights_loaded", WORKER_BOOT_S)
        served = event("weight_server", WORKER_BOOT_S)
        a_serving = event("serving", WORKER_BOOT_S)
        a_boot_s = time.perf_counter() - t0
        a_replies, a_errors, _ = _serve_over_http(
            a_serving["port"], bodies, WORKER_STREAMED)
        line, launches, replies, events_b = phase_worker(
            card, "worker_peer", ("--pages", "64", "--out", str(vol_b)),
            "PagedServer", ("flash_decode_paged",),
            forbid=("paged_fallback", "weight_fetch_fallback",
                    "weight_restore_fallback"),
            env={"WEIGHT_FETCH_PEERS": f"http://127.0.0.1:{served['port']}"},
            cwd=base / "b", worker_args=worker_args, launch=launch)
        health = _http_get(a_serving["port"], "/v1/healthz")
    finally:
        rc = _sigterm(proc)
    problems = list(a_errors)
    loaded_b = next(e for e in events_b
                    if e.get("event") == "weights_loaded")
    if loaded_a.get("source") != "init" or served.get("steps") != [0]:
        problems.append(f"worker A: {loaded_a}, {served}")
    if loaded_b.get("source") != "peer" \
            or line["worker_peer"]["cold_start"]["source"] != "peer":
        problems.append(f"worker B booted from {loaded_b}")
    step = "step-00000000-p0"
    man_a = json.loads((vol_a / step / "manifest.json").read_text())
    man_b = json.loads((vol_b / step / "manifest.json").read_text())
    files = [s for e in man_a["leaves"].values() for s in e["shards"]]
    n_bytes = sum(s["bytes"] for s in files)
    if man_a != man_b or sorted(p.name for p in (vol_b / step).iterdir()) \
            != sorted([s["file"] for s in files] + ["manifest.json"]):
        problems.append("VOL_B's step 0 differs from VOL_A's")
    if not health.get("ok") or rc != -signal.SIGTERM:
        problems.append(f"worker A: /v1/healthz {health}, exit {rc}")
    want = [(r or {}).get("tokens") for r in a_replies]
    divergences = []
    if replies != want:
        # the cut model A and B serve, as the worker initialises it
        cfg = cfg or dataclasses.replace(
            llama.LlamaConfig.llama3_8b(max_seq=2048), n_layers=layers)
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        divergences = _held_to(
            "worker_peer", dict(enumerate(replies)), dict(enumerate(want)),
            {i: b["prompt"] for i, b in enumerate(bodies)}, cfg, params,
            problems)
        del params
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("worker_peer phase: " + "; ".join(problems))
    body = line["worker_peer"]
    body.update({
        "model": f"llama3_8b width, {layers} of 32 layers",
        "peer_command": "WEIGHT_SERVE_PORT=0 python -m dcos_commons_tpu_torch"
                        ".frameworks.worker " + " ".join(args_a),
        "peer_boot_to_serving_s": a_boot_s,
        "seed_save_s": served["seed_save_s"],
        "step_bytes": n_bytes, "shards": len(files),
        "fetch_s": loaded_b["fetch_s"], "restore_s": loaded_b["restore_s"],
        "fetch_gb_per_s": n_bytes / 1e9 / max(loaded_b["fetch_s"], 1e-9),
        "restore_gb_per_s": n_bytes / 1e9 / max(loaded_b["restore_s"],
                                                1e-9),
        "near_tie_divergences": divergences,
        "replies_equal_worker_a": sum(a == b for a, b in zip(replies, want))})
    log(f"[worker_peer] {line}")
    return line, launches


# --------------------------------------------------------------- phase 15

# phase 15a's gang: two ranks on the one card over gloo (NCCL refuses two
# ranks on one device), Llama-3-8B in bf16 at full width and depth, then
# fp32 at TP_FP32_LAYERS of the 32 layers (the decode kernels take bf16,
# so the fp32 engines read the dense path on both sides)
TP_WORLD = 2
TP_FP32_LAYERS = 4
# the slot engine serves these of phase 3's 12 requests (one wave of its
# 8 slots, prompts of 64-1,500 tokens), in bf16 and in fp32: at all 12
# its eager bf16 drain took 40 s of the script's 1,200
TP_SLOT_REQUESTS = ("r0", "r1", "prefix-a", "prefix-b")
# eager decode windows of 8 steps timed at B=8 on the paged engine
TP_STEADY_WINDOWS = 2
TP_TIMEOUT_S = 900
# phase 15b: the worker gang at 8B width with TP_WORKER_LAYERS of the 32
# layers, the cut of phase 14b (``CUT_WORKER``)
TP_WORKER_LAYERS = PEER_LAYERS


def _tree_gb(tree) -> float:
    from dcos_commons_tpu_torch.ops.quant import QTensor
    if isinstance(tree, dict):
        return sum(_tree_gb(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return _tree_gb(tree.q) + _tree_gb(tree.s)
    return tree.numel() * tree.element_size() / 1e9


def tp_steady_streams(srv) -> None:
    """Reset ``srv`` and bring 8 streams of 1-64 prompt tokens to
    decoding (one prefill chunk each: a gang's eager chunk costs what a
    step does), max_new 200."""
    import numpy as np
    srv.reset()
    rng = np.random.default_rng(SEED + 1)
    srv.submit_many([{"prompt": _prompt(rng, n, srv.cfg.vocab_size),
                      "max_new": 200, "request_id": i} for i, n in
                     enumerate((1, 9, 17, 25, 33, 41, 49, 64))])
    while srv._prefill_q or srv._pending_first:
        srv.step()
    if len(srv._active()) != 8:
        raise RuntimeError(f"expected 8 decoding streams, got "
                           f"{srv._active()}")


def tp_rank(queue: list, slot_ids, cfg_kw: dict, fp32_layers: int,
            steady_windows: int, device: str = "cuda") -> dict:
    """One rank of phase 15a's gang (run by ``launch_local`` in a process
    of its own): this rank's shard of the 8B weights from the seed
    (``init_params(mesh=)``: every rank draws the whole tree and keeps its
    slice), ``PagedServer(mesh=)`` at phase 3's geometry draining
    ``queue`` and ``SlotServer(mesh=)`` draining its requests in
    ``slot_ids``, each with the kernel counts zeroed just before and read
    just after; an eager B=8 decode timing with the collectives' host
    seconds; then both engines in fp32 at ``fp32_layers`` layers on the
    same queues. Returns streams, counts, memory and times. ``device``
    ``"cpu"`` rehearses it on the CPU."""
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MeshSpec(tp=dist.get_world_size()).build(device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg = llama.LlamaConfig.llama3_8b(**cfg_kw)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
        mesh=mesh)
    _sync(dev)
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "layout": mesh.layout, "world": mesh.size,
           "init_s": time.perf_counter() - t0,
           "weight_gb": _tree_gb(params)}
    slot_queue = [r for r in queue if r["request_id"] in slot_ids]
    engines = (("paged", queue, lambda c, p: serving.PagedServer(
                   c, p, slots=8, page_size=64, prefill_chunk=64,
                   device=dev, mesh=mesh)),
               ("slots", slot_queue, lambda c, p: serving.SlotServer(
                   c, p, slots=8, device=dev, mesh=mesh)))
    for name, reqs, make in engines:
        srv = make(cfg, params)
        if name == "paged":
            srv.warmup()
        _zero_launches()
        c0 = mesh.collectives
        t0 = time.perf_counter()
        got = srv.drain([dict(r) for r in reqs], decode_window=8)
        _sync(dev)
        out[name] = {"streams": got, "wall_s": time.perf_counter() - t0,
                     "launches": _launch_counts(),
                     "collectives": mesh.collectives - c0,
                     "graphs": srv.graph_stats()["off_reason"]}
        if name == "paged":
            out[name]["ledger"] = srv.ledger_violations()
            out[name]["page_stats"] = srv.page_stats()
            tp_steady_streams(srv)
            c0, s0 = mesh.collectives, mesh.collective_s
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steady_windows):
                srv.step_many(8)
            _sync(dev)
            wall = time.perf_counter() - t0
            steps = 8 * steady_windows
            out["eager_step"] = {
                "step_ms": wall / steps * 1e3,
                "collectives_per_step": (mesh.collectives - c0) / steps,
                "collective_ms_per_step": (mesh.collective_s - s0)
                / steps * 1e3,
                "collective_share": (mesh.collective_s - s0) / wall}
        del srv
        if cuda:
            torch.cuda.empty_cache()
    del params
    if cuda:
        torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=fp32_layers,
                                dtype=torch.float32, decode_attn="dense")
    p32 = llama.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(SEED), device=dev,
        mesh=mesh)
    for name, reqs, make in engines:
        srv = make(cfg32, p32)
        out[name]["fp32_streams"] = srv.drain([dict(r) for r in reqs],
                                              decode_window=8)
        del srv
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if cuda else None)
    return out


def tp_fp32_reference(queue, slot_ids, cfg_kw, layers, dev) -> dict:
    """The single-device fp32 engines the gang's fp32 streams must
    equal: the same seed, width, layers and queues."""
    import torch
    from dcos_commons_tpu_torch.models import llama, serving
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(**cfg_kw),
                              n_layers=layers, dtype=torch.float32,
                              decode_attn="dense")
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    out = {"paged": serving.PagedServer(
               cfg, params, slots=8, page_size=64, prefill_chunk=64,
               device=dev).drain([dict(r) for r in queue], decode_window=8),
           "slots": serving.SlotServer(cfg, params, slots=8,
                                       device=dev).drain(
               [dict(r) for r in queue if r["request_id"] in slot_ids],
               decode_window=8)}
    del params
    return out


def tp_gang(solo, cfg_kw=None, dev="cuda") -> tuple:
    """Phase 15a's gang (``tp_rank``), its ranks' results and its
    seconds. It only waits on its processes here, so it runs beside
    phases of this process whose engines capture CUDA graphs; the
    checks that touch the card (:func:`phase_tp`) run after."""
    from dcos_commons_tpu_torch.parallel.distributed import launch_local

    t0 = time.perf_counter()
    ranks = launch_local(tp_rank, TP_WORLD, solo["queue"], TP_SLOT_REQUESTS,
                         cfg_kw or {"max_seq": 2048}, TP_FP32_LAYERS,
                         TP_STEADY_WINDOWS, dev, timeout_s=TP_TIMEOUT_S)
    return ranks, time.perf_counter() - t0


def phase_tp(card: str, params, solo, cfg_kw=None, dev="cuda",
             gang=None) -> tuple:
    """Phase 15a: tensor-parallel serving over a process mesh of
    ``TP_WORLD`` ranks sharing the card (:func:`tp_gang`, or its result
    ``gang`` where it ran beside another phase). Every rank's
    streams must equal rank 0's; each bf16 stream, teacher-forced through
    the parent's single-device weights (phase 3's), may leave phase 3's
    solo stream only at a near-tie; the fp32 streams must equal the
    single-device fp32 engines' token for token; kernel 1 must launch on
    every rank in the paged run, kernels 2 and 3 in the slot run.
    Returns (line, {kernel: launches summed over the ranks})."""
    import torch
    from dcos_commons_tpu_torch.models import llama

    cfg_kw = cfg_kw or {"max_seq": 2048}
    dev = torch.device(dev)
    queue = solo["queue"]
    cfg = llama.LlamaConfig.llama3_8b(**cfg_kw)
    ranks, gang_s = gang or tp_gang(solo, cfg_kw, dev.type)
    head, problems = ranks[0], []
    for r in ranks[1:]:
        for name in ("paged", "slots"):
            for key in ("streams", "fp32_streams"):
                if r[name][key] != head[name][key]:
                    problems.append(f"rank {r['rank']}'s {name} {key} "
                                    "differ from rank 0's")
    prompts = {q["request_id"]: q["prompt"] for q in queue}
    divergences = {}
    for name, ids in (("paged", sorted(prompts)),
                      ("slots", sorted(TP_SLOT_REQUESTS))):
        got = head[name]["streams"]
        if sorted(got) != ids or any(len(t) != 32 for t in got.values()):
            problems.append(f"{name}: streams {sorted(got)}")
            continue
        divergences[name] = stream_check(
            f"tp {name}", got, {i: solo["out"][i] for i in ids}, prompts,
            cfg, params)
    want32 = tp_fp32_reference(queue, TP_SLOT_REQUESTS, cfg_kw,
                               TP_FP32_LAYERS, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for name in ("paged", "slots"):
        if head[name]["fp32_streams"] != want32[name]:
            off = [rid for rid in want32[name]
                   if head[name]["fp32_streams"].get(rid)
                   != want32[name][rid]]
            problems.append(f"fp32 {name} streams differ from the "
                            f"single-device engine's: {off}")
    for r in ranks:
        need = {"paged": ("flash_decode_paged",),
                "slots": ("flash_decode", "flash_attention_fwd")}
        for name, kerns in need.items():
            for k in kerns:
                if r[name]["launches"][k] < 1 and dev.type == "cuda":
                    problems.append(f"rank {r['rank']}: {k} never launched "
                                    f"in the {name} run")
            if r[name]["graphs"] != "tp":
                problems.append(f"rank {r['rank']} {name}: graphs "
                                f"{r[name]['graphs']}")
        if r["paged"]["ledger"]:
            problems.append(f"rank {r['rank']} ledger {r['paged']['ledger']}")
    if problems:
        raise RuntimeError("tp phase: " + "; ".join(problems))
    launches = {k: sum(r[name]["launches"][k] for r in ranks
                       for name in ("paged", "slots"))
                for k in ("flash_decode_paged", "flash_decode",
                          "flash_attention_fwd")}
    tp_line = {"backend": head["backend"], "world": len(ranks),
               "devices": [r["device"] for r in ranks],
               "weight_gb_per_rank": [r["weight_gb"] for r in ranks],
               "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
               "card": card}
    log(f"[tp] {json.dumps(tp_line)}")
    line = {"tp": {
        **tp_line,
        "model": "llama3_8b", "max_seq": cfg.max_seq, "dtype": "bf16",
        "layers": cfg.n_layers, "tp": len(ranks),
        "layout": head["layout"], "init_s": [r["init_s"] for r in ranks],
        "gang_s": gang_s,
        "requests": {"paged": len(queue), "slots": len(TP_SLOT_REQUESTS)},
        "paged_wall_s": head["paged"]["wall_s"],
        "slots_wall_s": head["slots"]["wall_s"],
        "collectives": {n: head[n]["collectives"] for n in ("paged",
                                                            "slots")},
        "eager_step_b8": {
            **head["eager_step"], "prompt_lens": "1-64",
            "label": "two ranks sharing one card over gloo (not a TP "
                     "speed number)"},
        "launches_per_rank": [{n: r[n]["launches"] for n in ("paged",
                                                             "slots")}
                              for r in ranks],
        "near_tie_divergences": divergences,
        "fp32_layers": TP_FP32_LAYERS, "fp32_token_equal": True,
        "graphs": "eager under tp (gloo is not captured)",
        "page_stats_rank0": head["paged"]["page_stats"]}}
    log(f"[tp] {line}")
    return line, launches


def _tp_worker_procs(base: Path, worker_args, layers: int, env=None):
    """The two gang workers, each with the rank contract (cut to
    ``layers`` layers by ``CUT_WORKER``): [(proc, events, event)]."""
    from dcos_commons_tpu_torch.parallel.distributed import free_port
    root = Path(__file__).resolve().parent
    addr = f"127.0.0.1:{free_port()}"
    out = []
    for rank in range(TP_WORLD):
        cwd = base / f"r{rank}"
        cwd.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(
            [sys.executable, "-c", CUT_WORKER, str(layers), *worker_args],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=str(root),
                              JAX_COORDINATOR_ADDRESS=addr,
                              JAX_PROCESS_ID=str(rank),
                              JAX_NUM_PROCESSES=str(TP_WORLD),
                              POD_INSTANCE_INDEX=str(rank), **(env or {})),
            stdout=subprocess.PIPE, text=True)
        events = []
        out.append((proc, events, _event_reader(
            proc, events, ("paged_fallback",), f"gang worker {rank}")))
    return out


def phase_tp_worker(card: str, worker_args=WORKER_ARGS,
                    layers=TP_WORKER_LAYERS, dev="cuda", cfg=None) -> tuple:
    """Phase 15b: ``dist/llama.yml``'s gang, two ``python -m
    dcos_commons_tpu_torch.frameworks.worker llama --preset 8b --serve
    --slots 8`` processes with the ``JAX_*`` contract on the card, 8B
    width cut to ``layers`` layers (phase 14b's cut). Rank 0 answers phase
    6's 8 requests (one streamed); its ``/v1/stats`` must show them and
    the gang's counters, rank 1's heartbeats ``gang_iterations``; every
    reply equals the single-device ``SlotServer`` of the cut model or
    leaves it only at a near-tie; each rank's kernel counts are its own
    while it served. Returns (line, {kernel: launches over the ranks})."""
    import shutil
    import signal
    import torch
    from dcos_commons_tpu_torch.models import llama, serving

    base = Path(__file__).resolve().parent / "build" / "tp_worker"
    shutil.rmtree(base, ignore_errors=True)
    bodies = worker_bodies()
    t0 = time.perf_counter()
    gang = _tp_worker_procs(base, worker_args, layers)
    try:
        serving_ev = [event("serving", WORKER_BOOT_S)
                      for _, _, event in gang]
        boot_s = time.perf_counter() - t0
        port = serving_ev[0]["port"]
        replies, errors, wall = _serve_over_http(port, bodies,
                                                 WORKER_STREAMED)
        stats = _http_get(port, "/v1/stats")
        health = _http_get(port, "/v1/healthz")
        beats = [gang[0][2]("heartbeat", 60,
                            lambda e: e.get("requests", 0) >= len(bodies))]
        it0 = stats.get("gang_iterations", 0)
        beats.append(gang[1][2]("heartbeat", 60,
                                lambda e: e.get("gang_iterations", 0)
                                >= it0))
    finally:
        rcs = [_sigterm(proc) for proc, _, _ in gang]
    problems = list(errors)
    kerns = ("flash_decode", "flash_attention_fwd")
    launches = {}
    for rank, (ev, beat) in enumerate(zip(serving_ev, beats)):
        if not (ev.get("gang") and ev.get("tp") == TP_WORLD
                and ev.get("process_id") == rank):
            problems.append(f"rank {rank} serving event {ev}")
        if not beat.get("gang_iterations") or beat.get("gang_errors"):
            problems.append(f"rank {rank} heartbeat {beat}")
        for k in kerns:
            n = beat.get("launches", {}).get(k, 0) - ev.get(
                "launches", {}).get(k, 0)
            launches[k] = launches.get(k, 0) + n
            if n < 1 and torch.device(dev).type == "cuda":
                problems.append(f"rank {rank}: {k} never launched while "
                                "the gang served")
    if stats.get("requests") != len(bodies) or not stats.get(
            "gang_iterations") or stats.get("gang_errors"):
        problems.append(f"/v1/stats {stats}")
    if not health.get("ok") or any(rc != -signal.SIGTERM for rc in rcs):
        problems.append(f"/v1/healthz {health}, exits {rcs}")
    got = {i: (r or {}).get("tokens") for i, r in enumerate(replies)}
    if any(t is None or len(t) != 32 for t in got.values()):
        problems.append(f"replies {[len(t or []) for t in got.values()]}")
    cfg = cfg or dataclasses.replace(
        llama.LlamaConfig.llama3_8b(max_seq=2048), n_layers=layers)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    want = serving.SlotServer(cfg, params, slots=8, device=dev).drain(
        [{"prompt": b["prompt"], "max_new": 32, "request_id": i}
         for i, b in enumerate(bodies)], decode_window=8)
    divergences = _held_to("worker_tp", got, want,
                           {i: b["prompt"] for i, b in enumerate(bodies)},
                           cfg, params, problems)
    del params
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("worker_tp phase: " + "; ".join(problems))
    n_tok = sum(len(t) for t in got.values())
    line = {"worker_tp": {
        "command": "JAX_COORDINATOR_ADDRESS=127.0.0.1:P JAX_PROCESS_ID=r "
                   f"JAX_NUM_PROCESSES={TP_WORLD} python -m "
                   "dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(worker_args),
        "model": f"llama3_8b width, {layers} of 32 layers",
        "tp": TP_WORLD, "backend": serving_ev[0]["mesh"]["backend"],
        "devices": [e["mesh"]["device"] for e in serving_ev],
        "weight_gb_per_rank": [e["weight_gb"] for e in serving_ev],
        "boot_to_serving_s": boot_s, "requests": len(bodies),
        "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "gang_iterations": [b["gang_iterations"] for b in beats],
        "collectives_per_rank": [b.get("collectives") for b in beats],
        "launches": launches,
        "peak_mem_gb_per_rank": [b.get("peak_mem_gb") for b in beats],
        "replies_equal_single_device": sum(
            got[i] == want[i] for i in want),
        "near_tie_divergences": divergences, "card": card}}
    log(f"[worker_tp] {line}")
    return line, launches


# ---------------------------------------------------------------------------
# phase 16: data-parallel training over a process mesh (dist/resnet.yml,
# BASELINE config #4). The gang's ranks share the one card over gloo
# (NCCL refuses two ranks on a device): the arithmetic, the collectives,
# the boot and the resume are the card's; the speed is not a DP number.

DP_WORLD = 2
# 16a: fp32 ResNet-50 at full width and depth, 224^2, DP_CHECK_PER_RANK
# images a rank, held to one process over the gang's images: the loss
# within RESNET_LOSS_RTOL, every batch-norm state leaf within
# RESNET_LOGIT_TOL of its largest value, the three gradients within
# RESNET_GRAD_TOL of their largest with cosine >= RESNET_GRAD_COSINE (14a's
# card-vs-CPU bounds: cuDNN sums 8 images and 16 in other orders, and the
# batch statistics amplify that), and after DP_CHECK_STEPS steps the
# update's direction (params minus init) cosine >= DP_UPDATE_COSINE: the
# gang measured 0.9912 (predicted >= 0.999) and one process over the same
# images in reverse order 0.9927 against one process, the same rounding
# (Adam moves an element whose gradient is summation noise by its full
# rate either way); planted faults read 0.27 and 0.859
DP_CHECK_PER_RANK, DP_CHECK_STEPS = 8, 2
DP_GRAD_LEAVES = ("stem/conv", "stage2_block3/conv1", "head/w")
DP_UPDATE_COSINE = 0.98
# then bf16 at DP_BF16_PER_RANK images a rank (14a's global batch of 256)
DP_BF16_PER_RANK, DP_BF16_WARMUP, DP_BF16_STEPS = 128, 2, 4
# 16c: distill at Llama-3-8B width with the teacher cut to
# DP_DISTILL_LAYERS of its 32 layers, a 1-layer draft, DP_DISTILL_BATCH
# rows of DP_DISTILL_SEQ tokens (rank 0 backpropagates 2, rank 1 one, so
# the rows' weights matter), bf16: every loss within DP_DISTILL_RTOL of
# one process's over the same rows, and the draft's update after
# DP_DISTILL_STEPS steps (params minus init; the rate is 0 at step 0)
# held to one process's by cosine >= DP_DISTILL_UPDATE_COSINE and largest
# element error <= DP_DISTILL_UPDATE_ERR. Measured: the gang 0.99965 and
# 1.22e-3 (a bf16 step of the params), one process over the rows in
# reverse order 0.99993 and 5.5e-4; rows weighted equally instead of by
# their share read 0.846 on the CPU. Adam bounds each element's move by
# about its rates, so the error bound catches blow-ups, not direction
DP_DISTILL_LAYERS, DP_DISTILL_BATCH, DP_DISTILL_SEQ = 2, 3, 256
DP_DISTILL_STEPS, DP_DISTILL_RTOL = 3, 1e-3
DP_DISTILL_UPDATE_COSINE, DP_DISTILL_UPDATE_ERR = 0.995, 5e-3
# 16b: two `worker resnet --depth 50 --batch 128` processes under the
# rank contract, launched with these --steps in turn (rank 1's newest
# step removed before the third)
DP_WORKER_BATCH, DP_WORKER_STEPS = 128, (2, 3, 4)
DP_TIMEOUT_S = 900
# the card's sizes; a CPU rehearsal passes a smaller spec to phase_dp
DP_SPEC = {"depth": RESNET_DEPTH, "width": 64, "size": RESNET_SIZE,
           "check_per_rank": DP_CHECK_PER_RANK,
           "bf16_per_rank": DP_BF16_PER_RANK,
           "distill": {"max_seq": DP_DISTILL_SEQ, "remat": False,
                       "n_layers": DP_DISTILL_LAYERS}}


def dp_resnet_images(n: int, size: int):
    """The fp32 check's global batch: ``n`` images and labels from the
    seed on the host, the same on every process."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 16)
    return (torch.randn((n, size, size, 3), generator=gen),
            torch.randint(0, 1000, (n,), generator=gen, dtype=torch.int32))


def dp_resnet_check(dev, mesh, spec=DP_SPEC,
                    steps: int = DP_CHECK_STEPS, reverse: bool = False
                    ) -> dict:
    """The fp32 ResNet-50's first train pass (loss, accuracy, batch-norm
    state and the ``DP_GRAD_LEAVES`` gradients, averaged over dp on a
    mesh) and the update after ``steps`` steps (params minus the init),
    on this process's share of :func:`dp_resnet_images` (all of it
    without a mesh; ``reverse`` takes the images in reverse order, the
    same sums in another order). Host copies."""
    import hashlib
    import torch
    from dcos_commons_tpu_torch.models import resnet, train
    n = mesh.shape["dp"] if mesh is not None else 1
    r = mesh.coords["dp"] if mesh is not None else 0
    cfg = resnet.ResNetConfig(depth=spec["depth"], width=spec["width"],
                              n_classes=1000, dtype=torch.float32)
    x, y = dp_resnet_images(DP_WORLD * spec["check_per_rank"], spec["size"])
    if reverse:
        x, y = x.flip(0), y.flip(0)
    per = x.shape[0] // n
    rows = slice(r * per, (r + 1) * per)
    batch = (x[rows].to(dev), y[rows].to(dev))
    params, state = resnet.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    init = {k: v.detach().to("cpu", copy=True) for k, v in _named(params)}
    leaves = train._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, (acc, new_state) = resnet.loss_fn(cfg, params, state, batch,
                                            mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    loss, acc = loss.detach(), acc.float()
    if mesh is not None:
        grads, (loss, acc) = mesh.reduce_grads(grads, (loss, acc), 1.0 / n)
    names = [k for k, _ in _named(params)]
    out = {"loss": float(loss), "acc": float(acc),
           "state": {k: v.detach().cpu() for k, v in _named(new_state)},
           "grads": {k: g.cpu() for k, g in zip(names, grads)
                     if k in DP_GRAD_LEAVES}}
    opt = train.make_optimizer(lr=0.1)
    step = train.make_train_step(
        lambda p, b: resnet.loss_fn(cfg, p, b[0], b[1], mesh=mesh), opt,
        has_aux_state=True, mesh=mesh)
    opt_state = train.init_opt_state(opt, params)
    for _ in range(steps):
        params, opt_state, state, _ = step(params, opt_state, (state, batch))
    h = hashlib.sha1()
    for tree in (params, opt_state.mu, opt_state.nu, state):
        for _, v in _named(tree):
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
    out["digest"] = h.hexdigest()
    out["update"] = {k: v.cpu() - init[k] for k, v in _named(params)}
    out["rates"] = sum(opt.schedule(i) for i in range(steps))
    return out


def dp_distill(dev, mesh, spec=DP_SPEC, steps: int = DP_DISTILL_STEPS,
               reverse: bool = False, keep: bool = True) -> dict:
    """16c's distill at 8B width (the teacher at ``DP_DISTILL_LAYERS``
    layers, a 1-layer draft) over ``DP_DISTILL_BATCH`` rows, each rank
    backpropagating its own on a mesh (``reverse``: the rows in reverse
    order): the losses, the kernel counts of the run (zeroed just before),
    on a mesh a digest of the draft and its moments, and with ``keep`` the
    draft's leaves at the init and after the steps (on the device)."""
    import hashlib
    import torch
    from dcos_commons_tpu_torch.models import llama, train
    from dcos_commons_tpu_torch.models.speculative import (distill_loss,
                                                           draft_student)
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    cfg_t = llama.LlamaConfig.llama3_8b(**spec["distill"])
    gen = torch.Generator(device=dev)
    params_t = llama.init_params(cfg_t, gen.manual_seed(SEED), device=dev)
    cfg_d, params_d = draft_student(cfg_t, params_t, 1)
    init = [v.clone() for _, v in _named(params_d)] if keep else None
    toks = torch.randint(0, cfg_t.vocab_size,
                         (DP_DISTILL_BATCH, cfg_t.max_seq),
                         generator=gen.manual_seed(SEED + 1),
                         dtype=torch.int32, device=dev)
    if reverse:
        toks = toks.flip(0)
    opt = train.make_optimizer(lr=1e-3, warmup=5, decay_steps=10)
    step = train.make_train_step(distill_loss(cfg_t, params_t, cfg_d, 1.0),
                                 opt, mesh=mesh, batch_spec=None)
    opt_state = train.init_opt_state(opt, params_d)
    for name in FA_KERNELS:
        getattr(fa, name).launches = 0
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        params_d, opt_state, out = step(params_d, opt_state, toks)
        losses.append(float(out["loss"]))
    wall = time.perf_counter() - t0
    launches = {name: getattr(fa, name).launches for name in FA_KERNELS}
    out = {"losses": losses, "launches": launches, "step_s": wall / steps,
           "rows": (0, DP_DISTILL_BATCH)}
    if keep:
        out["init"] = init
        out["final"] = [v.detach() for _, v in _named(params_d)]
    if mesh is not None:
        h = hashlib.sha1()
        for tree in (params_d, opt_state.mu, opt_state.nu):
            for _, v in _named(tree):
                h.update(v.detach().contiguous().view(torch.int16).cpu()
                         .numpy().tobytes() if v.dtype == torch.bfloat16
                         else v.detach().cpu().numpy().tobytes())
        out["digest"] = h.hexdigest()
        out["rows"] = train.dp_rows(DP_DISTILL_BATCH, mesh)
    return out


def update_agreement(got: dict, want: dict) -> dict:
    """How far ``got``'s update (final minus init, over every leaf, on
    the device) lies from ``want``'s from the same init: cosine, largest
    element error, the share of elements that differ."""
    import torch
    dot = n_got = n_want = 0.0
    err, differ, total = 0.0, 0, 0
    for a0, a, b in zip(want["init"], got["final"], want["final"]):
        u = a.float() - a0.float()
        w = b.float() - a0.float()
        dot += float((u.double() * w.double()).sum())
        n_got += float(u.double().square().sum())
        n_want += float(w.double().square().sum())
        err = max(err, float((u - w).abs().max()))
        differ += int((u != w).sum())
        total += u.numel()
        del u, w
    return {"cosine": dot / max(1e-300, (n_got * n_want) ** 0.5),
            "max_err": err, "differing_share": differ / total}


def dp_rank(device: str = "cuda", spec=DP_SPEC) -> dict:
    """One rank of phase 16a and 16c (run by ``launch_local`` in a process
    of its own): ``MeshSpec(dp=world)``, :func:`dp_resnet_check` on this
    rank's images, the bf16 ResNet-50 steps at ``DP_BF16_PER_RANK``
    images a rank (step ms, collectives and their host seconds, peak
    memory), then :func:`dp_distill`. ``device`` ``"cpu"`` rehearses it
    on the CPU."""
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import resnet, train
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshSpec(dp=dist.get_world_size()).build(device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "layout": mesh.layout}
    c0, t0 = mesh.collectives, time.perf_counter()
    out["fp32"] = dp_resnet_check(dev, mesh, spec)
    out["fp32"]["collectives"] = mesh.collectives - c0
    out["part_s"] = {"fp32_check": time.perf_counter() - t0}
    t_bf16 = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    torch.backends.cudnn.benchmark = cuda
    cfg = resnet.ResNetConfig(depth=spec["depth"], width=spec["width"],
                              n_classes=1000)
    gen = torch.Generator(device=dev)
    params, state = resnet.init_params(cfg, gen.manual_seed(SEED),
                                       device=dev)
    per, size = spec["bf16_per_rank"], spec["size"]
    x = torch.randn((per, size, size, 3), dtype=torch.bfloat16,
                    generator=gen.manual_seed(SEED + 1 + mesh.rank),
                    device=dev)
    y = torch.randint(0, 1000, (per,), dtype=torch.int32,
                      generator=gen.manual_seed(SEED + 100 + mesh.rank),
                      device=dev)
    opt = train.make_optimizer(lr=0.1)
    step = train.make_train_step(
        lambda p, b: resnet.loss_fn(cfg, p, b[0], b[1], mesh=mesh), opt,
        has_aux_state=True, mesh=mesh)
    opt_state = train.init_opt_state(opt, params)
    losses = []
    for _ in range(DP_BF16_WARMUP):
        params, opt_state, state, o = step(params, opt_state, (state, (x, y)))
        losses.append(float(o["loss"]))
    _sync(dev)
    c0, s0 = mesh.collectives, mesh.collective_s
    t0 = time.perf_counter()
    for _ in range(DP_BF16_STEPS):
        params, opt_state, state, o = step(params, opt_state, (state, (x, y)))
    losses.append(float(o["loss"]))
    _sync(dev)
    wall = time.perf_counter() - t0
    out["bf16"] = {
        "images_per_rank": per, "steps": DP_BF16_STEPS,
        "step_ms": wall / DP_BF16_STEPS * 1e3,
        "collectives_per_step": (mesh.collectives - c0) / DP_BF16_STEPS,
        "collective_ms_per_step": (mesh.collective_s - s0)
        / DP_BF16_STEPS * 1e3,
        "collective_share": (mesh.collective_s - s0) / wall,
        "losses": losses,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None)}
    torch.backends.cudnn.benchmark = False
    del params, state, opt_state, x, y
    if cuda:
        torch.cuda.empty_cache()
    out["part_s"]["bf16"] = time.perf_counter() - t_bf16
    t0 = time.perf_counter()
    d = dp_distill(dev, mesh, spec, keep=mesh.rank == 0)
    out["part_s"]["distill"] = time.perf_counter() - t0
    if mesh.rank == 0:
        # the ranks hold the same bits (the digests): rank 0 holds its
        # draft to one process over the same rows, and, for the rounding
        # floor, one process over the rows in reverse order to it
        t0 = time.perf_counter()
        want = dp_distill(dev, None, spec)
        d["vs_one_process"] = update_agreement(d, want)
        del d["init"], d["final"]
        witness = dp_distill(dev, None, spec, reverse=True)
        d["one_process_reordered"] = update_agreement(witness, want)
        d["one_process_losses"] = want["losses"]
        d["one_process_step_s"] = want["step_s"]
        d["reordered_losses"] = witness["losses"]
        del want, witness
        out["part_s"]["distill_one_process"] = time.perf_counter() - t0
    out["distill"] = d
    return out


def _rel_max(a, b) -> float:
    """max |a - b| over max |b| (at least 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _cos(a, b) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()))


def _resnet_agreement(got: dict, want: dict) -> dict:
    """:func:`dp_resnet_check`'s ``got`` against ``want``: the loss, the
    batch-norm state, the gradients, the update's cosine and largest
    element error."""
    import torch
    err = {"loss_rel_err": abs(got["loss"] / want["loss"] - 1),
           "acc": got["acc"], "acc_one_process": want["acc"],
           "state_err": max(_rel_max(got["state"][k], v)
                            for k, v in want["state"].items())}
    for k, g in want["grads"].items():
        err[f"grad_err {k}"] = float((got["grads"][k] - g).abs().max()
                                     / g.abs().max())
        err[f"grad_cosine {k}"] = _cos(got["grads"][k], g)
    upd_w = torch.cat([v.flatten() for v in want["update"].values()])
    upd_g = torch.cat([got["update"][k].flatten() for k in want["update"]])
    err["update_cosine"] = _cos(upd_g, upd_w)
    err["update_max_err"] = float((upd_g - upd_w).abs().max())
    return err


def phase_dp(card: str, dev="cuda", spec=DP_SPEC) -> tuple:
    """Phases 16a and 16c: the fp32 ResNet-50 reference in this process
    first (one process over all ``DP_WORLD x DP_CHECK_PER_RANK`` images,
    and over them in reverse order for the rounding floor), then a gang
    of ``DP_WORLD`` ranks sharing the card (:func:`dp_rank`), each held to
    it, and distill held to one process in rank 0; params, optimizer and
    batch-norm state bitwise equal across ranks. Returns (line, {kernel:
    launches summed over the ranks' distill runs})."""
    import math
    import torch
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    want = dp_resnet_check(dev, None, spec)
    ref_s = {"fp32_check": time.perf_counter() - t0}
    t0 = time.perf_counter()
    reordered = _resnet_agreement(dp_resnet_check(dev, None, spec,
                                                  reverse=True), want)
    ref_s["fp32_reordered"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch_local(dp_rank, DP_WORLD, dev.type, spec,
                         timeout_s=DP_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    problems, fp32 = [], []
    distill = ranks[0]["distill"]
    for r in ranks:
        got = r["fp32"]
        err = _resnet_agreement(got, want)
        err["rates"] = want["rates"]
        err["collectives"] = got["collectives"]
        fp32.append(err)
        if err["loss_rel_err"] > RESNET_LOSS_RTOL:
            problems.append(f"rank {r['rank']} loss {err['loss_rel_err']}")
        if err["state_err"] > RESNET_LOGIT_TOL:
            problems.append(f"rank {r['rank']} state {err['state_err']}")
        for k in want["grads"]:
            if err[f"grad_err {k}"] > RESNET_GRAD_TOL \
                    or err[f"grad_cosine {k}"] < RESNET_GRAD_COSINE:
                problems.append(f"rank {r['rank']} gradient {k}: "
                                f"{err[f'grad_err {k}']}, cosine "
                                f"{err[f'grad_cosine {k}']}")
        if err["update_cosine"] < DP_UPDATE_COSINE:
            problems.append(f"rank {r['rank']} update cosine "
                            f"{err['update_cosine']}")
        d = r["distill"]
        rel = max(abs(a / b - 1) for a, b in zip(
            d["losses"], distill["one_process_losses"]))
        if rel > DP_DISTILL_RTOL:
            problems.append(f"rank {r['rank']} distill losses {d['losses']} "
                            f"against {distill['one_process_losses']}")
        if dev.type == "cuda" and min(d["launches"].values()) < 1:
            problems.append(f"rank {r['rank']} distill kernels "
                            f"{d['launches']}")
        if not all(math.isfinite(v) for v in r["bf16"]["losses"]):
            problems.append(f"rank {r['rank']} bf16 losses "
                            f"{r['bf16']['losses']}")
    agree = distill["vs_one_process"]
    if agree["cosine"] < DP_DISTILL_UPDATE_COSINE \
            or agree["max_err"] > DP_DISTILL_UPDATE_ERR:
        problems.append(f"distill update against one process {agree}")
    for key in ("fp32", "distill"):
        if len({r[key]["digest"] for r in ranks}) != 1:
            problems.append(f"{key}: the ranks' params, moments or state "
                            "differ")
    if len({tuple(r["bf16"]["losses"]) for r in ranks}) != 1:
        problems.append("bf16: the ranks' losses differ")
    if problems:
        raise RuntimeError("dp phase: " + "; ".join(problems))
    launches = {k: sum(r["distill"]["launches"][k] for r in ranks)
                for k in FA_KERNELS}
    line = {"dp": {
        "world": len(ranks), "backend": ranks[0]["backend"],
        "devices": [r["device"] for r in ranks],
        "layout": ranks[0]["layout"], "reference_s": ref_s,
        "gang_s": gang_s, "rank_part_s": [r["part_s"] for r in ranks],
        "card": card,
        "resnet50_fp32_check": {
            "depth": spec["depth"], "width": spec["width"],
            "images_per_rank": spec["check_per_rank"], "image": spec["size"],
            "steps": DP_CHECK_STEPS, "loss": want["loss"],
            "per_rank": fp32, "one_process_reordered": reordered,
            "ranks_bitwise_equal": True,
            "tolerances": {"loss_rtol": RESNET_LOSS_RTOL,
                           "state": RESNET_LOGIT_TOL,
                           "grad": RESNET_GRAD_TOL,
                           "grad_cosine": RESNET_GRAD_COSINE,
                           "update_cosine": DP_UPDATE_COSINE}},
        "resnet50_bf16": {
            **{k: [r["bf16"][k] for r in ranks] for k in (
                "step_ms", "collectives_per_step", "collective_ms_per_step",
                "collective_share", "peak_mem_gb")},
            "images_per_rank": ranks[0]["bf16"]["images_per_rank"],
            "global_batch": DP_WORLD * ranks[0]["bf16"]["images_per_rank"],
            "losses": ranks[0]["bf16"]["losses"],
            "label": "two ranks on one card; not a DP speed"},
        "distill": {
            "model": "llama3_8b width", "config": {
                k: v for k, v in spec["distill"].items()},
            "draft_layers": 1, "batch": DP_DISTILL_BATCH,
            "seq": spec["distill"]["max_seq"],
            "losses": distill["losses"],
            "one_process_losses": distill["one_process_losses"],
            "reordered_losses": distill["reordered_losses"],
            "rtol": DP_DISTILL_RTOL,
            "update_vs_one_process": distill["vs_one_process"],
            "update_one_process_reordered":
                distill["one_process_reordered"],
            "update_bounds": {"cosine": DP_DISTILL_UPDATE_COSINE,
                              "max_err": DP_DISTILL_UPDATE_ERR},
            "rows_per_rank": [r["distill"]["rows"] for r in ranks],
            "launches_per_rank": [r["distill"]["launches"] for r in ranks],
            "step_s_per_rank": [r["distill"]["step_s"] for r in ranks],
            "one_process_step_s": distill["one_process_step_s"],
            "ranks_bitwise_equal": True}}}
    log(f"[dp] {json.dumps(line)}")
    return line, launches


def _gang_worker_run(args, base: Path, world: int = DP_WORLD, env=None,
                     on_event=None):
    """``world`` worker processes with the rank contract, each in
    ``base/r<rank>`` with ``--out`` there: [(exit code, events)] in rank
    order. ``on_event(rank, proc, event)`` sees each event as it
    arrives."""
    from dcos_commons_tpu_torch.parallel.distributed import free_port
    addr = f"127.0.0.1:{free_port()}"
    results = [None] * world

    def rank_run(r):
        cwd = base / f"r{r}"
        cwd.mkdir(parents=True, exist_ok=True)
        results[r] = _worker_run([*args, "--out", str(cwd / "vol")], cwd,
                                 on_event=(None if on_event is None else
                                           lambda p, e: on_event(r, p, e)),
                                 env={"JAX_COORDINATOR_ADDRESS": addr,
                                      "JAX_PROCESS_ID": str(r),
                                      "JAX_NUM_PROCESSES": str(world),
                                      "POD_INSTANCE_INDEX": str(r),
                                      **(env or {})})

    _side_by_side(*[lambda r=r: rank_run(r) for r in range(world)])
    return results


def phase_dp_worker(card: str, depth=RESNET_DEPTH, batch=DP_WORKER_BATCH,
                    steps=DP_WORKER_STEPS, extra=()) -> dict:
    """Phase 16b: ``dist/resnet.yml``'s gang, two ``worker resnet --depth
    50 --batch 128 --emit-every 1 --out VOL`` processes under the rank
    contract (in ``build/dp_worker_smoke``), launched with ``--steps``
    ``steps[0]``, then ``steps[1]`` (both must emit ``resumed`` at
    ``steps[0]``), then, with rank 1's newest step removed, ``steps[2]``
    (both must resume at ``steps[0]``, the step they share). Every
    launch: both ranks exit 0 with the same ``final_loss`` and progress
    stream and report ``global_batch`` 2 x batch. The ``worker_dp``
    line."""
    import math
    import shutil
    base = Path(__file__).resolve().parent / "build" / "dp_worker_smoke"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0_phase = time.perf_counter()
    rn = ["resnet", "--depth", str(depth), "--batch", str(batch),
          "--emit-every", "1", *extra]
    runs, problems = [], []
    for i, n in enumerate(steps):
        if i == 2:
            vol = base / "r1" / "vol"
            newest = sorted(d for d in os.listdir(vol)
                            if d.startswith("step-"))[-1]
            shutil.rmtree(vol / newest)
        t0 = time.perf_counter()
        res = _gang_worker_run([*rn, "--steps", str(n)], base)
        wall = time.perf_counter() - t0
        dones, resumed, progress = [], [], []
        for r, (rc, events) in enumerate(res):
            done = [e for e in events if e.get("event") == "done"]
            if rc != 0 or not done:
                problems.append(f"launch {i} rank {r}: exit {rc}, "
                                f"{events[-2:]}")
                continue
            dones.append(done[0])
            resumed.append([e["step"] for e in events
                            if e.get("event") == "resumed"])
            progress.append([(e["step"], e["loss"]) for e in events
                             if e.get("event") == "progress"])
        runs.append({"steps": n, "wall_s": wall, "resumed": resumed,
                     "final_loss": [d["final_loss"] for d in dones],
                     "progress": progress[:1],
                     "images_per_sec_per_chip": [
                         d["images_per_sec_per_chip"] for d in dones],
                     "collectives": [d.get("collectives") for d in dones],
                     "collective_s": [d.get("collective_s") for d in dones],
                     "peak_mem_gb": [d.get("peak_mem_gb") for d in dones]})
        if len(dones) != DP_WORLD:
            continue
        want_resume = [] if i == 0 else [steps[0]]
        if any(r != want_resume for r in resumed):
            problems.append(f"launch {i}: resumed {resumed}, want "
                            f"{want_resume} on every rank")
        if len({d["final_loss"] for d in dones}) != 1 \
                or not math.isfinite(dones[0]["final_loss"] or math.nan):
            problems.append(f"launch {i}: final losses "
                            f"{[d['final_loss'] for d in dones]}")
        if progress[0] != progress[1]:
            problems.append(f"launch {i}: progress streams differ")
        if any(d["global_batch"] != DP_WORLD * batch for d in dones):
            problems.append(f"launch {i}: global_batch "
                            f"{[d['global_batch'] for d in dones]}")
    if len(runs) == 3 and runs[1]["progress"] and runs[2]["progress"]:
        a, b = dict(runs[1]["progress"][0]), dict(runs[2]["progress"][0])
        runs[2]["step_loss_vs_launch_1"] = {
            s: (a[s], b[s]) for s in sorted(set(a) & set(b))}
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("dp worker phase: " + "; ".join(problems))
    line = {"worker_dp": {
        "command": f"{DP_WORLD} x python -m dcos_commons_tpu_torch."
                   f"frameworks.worker resnet --depth {depth} --batch "
                   f"{batch} --emit-every 1 --out VOL under "
                   "JAX_COORDINATOR_ADDRESS/JAX_PROCESS_ID/"
                   f"JAX_NUM_PROCESSES, --steps {steps[0]}, then "
                   f"{steps[1]}, then {steps[2]} with rank 1's newest step "
                   "removed", "runs": runs,
        "wall_s": time.perf_counter() - t0_phase,
        "label": "two ranks on one card; not a DP speed", "card": card}}
    log(f"[worker_dp] {json.dumps(line)}")
    return line


# --------------------------------------------------------------- phase 17

TPT_WORLD = 2
# 17a: a tp gang of TPT_WORLD ranks sharing the card over gloo trains
# llama_400m at phase 4's shape and seed: bf16 at full depth with
# --attn flash (kernels 3-5 on each rank's 6 query and 3 KV heads), a
# warm-up and TPT_BF16_STEPS timed steps; then fp32 at TPT_FP32_LAYERS
# layers with dense attention, held whole (every gradient leaf gathered
# over tp) to one process of the port on the same weights and batch in
# rank 0: the first pass's loss within TPT_LOSS_RTOL, each gradient leaf
# within TPT_GRAD_TOL of its largest with cosine >= TPT_GRAD_COSINE, and
# after TPT_FP32_STEPS steps the update (params minus init; the rate is 0
# at step 0) by cosine >= TPT_UPDATE_COSINE. The bf16 warm-up loss within
# LOSS_ATOL of one process's bf16 loss on the whole init. Bounds written
# before the first card run (PERF.md §6)
TPT_BF16_STEPS = 3
TPT_FP32_LAYERS, TPT_FP32_STEPS = 2, 2
TPT_LOSS_RTOL, TPT_GRAD_TOL, TPT_GRAD_COSINE = 1e-5, 1e-3, 0.9999
TPT_UPDATE_COSINE = 0.99
TPT_TIMEOUT_S = 600
# the card's sizes; a CPU rehearsal passes a smaller spec
TPT_SPEC = {"preset": "llama_400m", "cfg": {}, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "fp32_layers": TPT_FP32_LAYERS}
# 17b: two `worker llama-train --sp 1 --tp 2 --attn flash --out VOL`
# processes under the rank contract, launched with these --steps in turn
# (rank 1's newest step removed before the third)
TPT_WORKER_STEPS = (2, 4, 4)
TPT_WORKER_LAYERS = 4                   # LlamaConfig.tiny


def tp_collectives_per_step(layers: int, seq: int, block: int,
                            fused: bool = True, dp: int = 1) -> int:
    """The collectives of one tp train step, from the code: one for the
    embedding's "g", four a layer ("f" backward and "g" forward around
    attention and the FFN), the fused head's two a sequence block forward
    and one backward (unfused: the gather and its input's "f"), one for
    the clip's norm and, with dp, one gradient reduction."""
    head = 2 * -(-(seq - 1) // block) + 1 if fused else 2
    return 1 + 4 * layers + head + 1 + (dp > 1)


def _replicated_digest(trees) -> str:
    import hashlib
    h = hashlib.sha1()
    for tree in trees:
        for name, t in sorted(_named(tree)):
            if name.endswith("norm"):
                h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_train_rank(device: str = "cuda", spec=TPT_SPEC) -> dict:
    """One rank of phase 17a (run by ``launch_local`` in a process of its
    own): ``MeshSpec(tp=world)``; the bf16 steps at full depth through
    the kernels (step ms, collectives and their host ms, peak memory, the
    kernels' launches counted from 0 around the warm-up and the steps);
    in rank 0 one process's bf16 loss on the whole init; then the fp32
    check, every leaf gathered whole, held in rank 0 to one process on
    the same weights. ``device`` ``"cpu"`` rehearses it on the CPU."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import llama, train
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, gather_whole

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MeshSpec(tp=dist.get_world_size()).build(device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    preset = getattr(llama.LlamaConfig, spec["preset"])
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "layout": mesh.layout, "part_s": {}}
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, preset(**spec["cfg"]).vocab_size,
        (spec["batch"], spec["seq"])).astype(np.int32)).to(dev)

    def run(cfg, seed, n_steps, **opt_kw):
        """The gang's ``n_steps`` from ``init_params(mesh=)``: (params,
        losses, step seconds, collectives and their host seconds a
        step)."""
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
            mesh=mesh)
        opt = train.make_optimizer(**opt_kw)
        step = train.make_train_step(
            lambda p, b: llama.loss_fn(cfg, p, b, mesh), opt, mesh=mesh,
            batch_spec=None, param_spec_tree=llama.param_specs(cfg))
        state = train.init_opt_state(opt, params)
        losses, secs, counts, coll_s = [], [], [], []
        for _ in range(n_steps):
            _sync(dev)
            c0, s0, t0 = mesh.collectives, mesh.collective_s, \
                time.perf_counter()
            params, state, o = step(params, state, toks)
            losses.append(float(o["loss"]))
            secs.append(time.perf_counter() - t0)
            counts.append(mesh.collectives - c0)
            coll_s.append(mesh.collective_s - s0)
        return params, state, losses, secs, counts, coll_s

    # bf16 at full depth through the kernels: phase 4's weights and batch
    t0 = time.perf_counter()
    cfg = preset(max_seq=spec["seq"], remat=False, attn_impl="flash",
                 **spec["cfg"])
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    counters = [getattr(fa, name) for name in FA_KERNELS]
    for c in counters:
        c.launches = 0
    params, state, losses, secs, counts, coll_s = run(
        cfg, SEED, 1 + TPT_BF16_STEPS, lr=3e-4, warmup=10, decay_steps=1000)
    launches = {name: c.launches for name, c in zip(FA_KERNELS, counters)}
    timed = slice(1, None)
    out["bf16"] = {
        "layers": cfg.n_layers, "heads_per_rank": cfg.n_heads // mesh.size,
        "kv_heads_per_rank": cfg.n_kv_heads // mesh.size,
        "losses": losses, "warmup_s": secs[0],
        "step_ms": float(np.mean(secs[timed])) * 1e3,
        "collectives_per_step": counts,
        "collective_ms_per_step": float(np.mean(coll_s[timed])) * 1e3,
        "collective_share": sum(coll_s[timed]) / sum(secs[timed]),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None),
        "launches": launches,
        "replicated_digest": _replicated_digest(
            (params, state.mu, state.nu))}
    del params, state
    if mesh.rank == 0:
        whole = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        with torch.no_grad():
            one = float(llama.loss_fn(cfg, whole, toks)[0])
        out["bf16"]["one_process_loss"] = one
        out["bf16"]["loss_abs_err"] = abs(losses[0] - one)
        del whole
    if cuda:
        torch.cuda.empty_cache()
    out["part_s"]["bf16"] = time.perf_counter() - t0

    # fp32 at spec["fp32_layers"] layers, dense attention
    t0 = time.perf_counter()
    cfg32 = preset(max_seq=spec["seq"], remat=False, attn_impl="dense",
                   dtype=torch.float32,
                   **{**spec["cfg"], "n_layers": spec["fp32_layers"]})
    specs = llama.param_specs(cfg32)
    seed32 = SEED + 17
    params = llama.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(seed32), device=dev,
        mesh=mesh)
    leaves = train._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    c0 = mesh.collectives
    loss, acc = llama.loss_fn(cfg32, params, toks, mesh)
    grads = torch.autograd.grad(loss, leaves)
    first_collectives = mesh.collectives - c0
    for t in leaves:
        t.requires_grad_(False)
    names = [n for n, _ in _named(params)]
    spec_of = dict(_named(specs))
    grads = {n: gather_whole(g, spec_of[n], mesh)
             for n, g in zip(names, grads)}
    del params, leaves
    params, state, losses32, _, counts32, _ = run(
        cfg32, seed32, TPT_FP32_STEPS, lr=3e-4, warmup=10, decay_steps=1000)
    out["fp32"] = {"loss": float(loss.detach()), "acc": float(acc),
                   "first_pass_collectives": first_collectives,
                   "losses": losses32, "collectives_per_step": counts32,
                   "replicated_digest": _replicated_digest(
                       (params, state.mu, state.nu))}
    final = {n: gather_whole(t, spec_of[n], mesh)
             for n, t in _named(params)}
    del params, state
    if mesh.rank == 0:
        whole = llama.init_params(
            cfg32, torch.Generator(device=dev).manual_seed(seed32),
            device=dev)
        init = {n: t.clone() for n, t in _named(whole)}
        w_leaves = train._leaves(whole)
        for t in w_leaves:
            t.requires_grad_(True)
        w_loss, w_acc = llama.loss_fn(cfg32, whole, toks)
        w_grads = dict(zip([n for n, _ in _named(whole)],
                           torch.autograd.grad(w_loss, w_leaves)))
        for t in w_leaves:
            t.requires_grad_(False)
        err = {"loss_rel_err": abs(float(loss) / float(w_loss) - 1),
               "acc": float(acc), "acc_one_process": float(w_acc)}
        for n, g in w_grads.items():
            err[f"grad_err {n}"] = _rel_max(grads[n], g)
            err[f"grad_cosine {n}"] = _cos(grads[n], g)
        del grads, w_grads
        opt = train.make_optimizer(lr=3e-4, warmup=10, decay_steps=1000)
        step = train.make_train_step(lambda p, b: llama.loss_fn(cfg32, p, b),
                                     opt)
        state = train.init_opt_state(opt, whole)
        one_losses = []
        for _ in range(TPT_FP32_STEPS):
            whole, state, o = step(whole, state, toks)
            one_losses.append(float(o["loss"]))
        d = update_agreement({"final": [final[n] for n in init]},
                             {"init": list(init.values()),
                              "final": [t for _, t in _named(whole)]})
        err.update({"update_" + k: v for k, v in d.items()},
                   one_process_losses=one_losses)
        out["fp32"]["vs_one_process"] = err
        del whole, state, init
    del final
    if cuda:
        torch.cuda.empty_cache()
    out["part_s"]["fp32"] = time.perf_counter() - t0
    return out


def phase_tp_train(card: str, dev="cuda", spec=TPT_SPEC) -> tuple:
    """Phase 17a: a gang of ``TPT_WORLD`` ranks sharing the card
    (:func:`tp_train_rank`), the fp32 check's agreement read from rank 0,
    the replicated leaves (the norms and their moments) bitwise equal on
    every rank, one loss stream, the collectives a step against
    :func:`tp_collectives_per_step`, and every kernel launched on each
    rank. Returns (line, {kernel: launches summed over the ranks})."""
    import math
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    dev = torch.device(dev)
    t0 = time.perf_counter()
    ranks = launch_local(tp_train_rank, TPT_WORLD, dev.type, spec,
                         timeout_s=TPT_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    preset = getattr(llama.LlamaConfig, spec["preset"])
    cfg = preset(**spec["cfg"])
    block = cfg.fused_ce_block
    want_bf16 = tp_collectives_per_step(cfg.n_layers, spec["seq"], block)
    want_fp32 = tp_collectives_per_step(spec["fp32_layers"], spec["seq"],
                                        block)
    problems = []
    head = ranks[0]
    for r in ranks:
        b, f = r["bf16"], r["fp32"]
        if b["collectives_per_step"] != [want_bf16] * (1 + TPT_BF16_STEPS):
            problems.append(f"rank {r['rank']} bf16 collectives "
                            f"{b['collectives_per_step']}, want {want_bf16}")
        if f["collectives_per_step"] != [want_fp32] * TPT_FP32_STEPS \
                or f["first_pass_collectives"] != want_fp32 - 1:
            problems.append(f"rank {r['rank']} fp32 collectives "
                            f"{f['first_pass_collectives']}, "
                            f"{f['collectives_per_step']}, want {want_fp32}")
        if not all(math.isfinite(x) for x in b["losses"]):
            problems.append(f"rank {r['rank']} bf16 losses {b['losses']}")
        if dev.type == "cuda" and set(b["launches"].values()) != {
                cfg.n_layers * (1 + TPT_BF16_STEPS)}:
            problems.append(f"rank {r['rank']} kernel launches "
                            f"{b['launches']}")
        for part in ("bf16", "fp32"):
            if r[part]["replicated_digest"] != head[part]["replicated_digest"]:
                problems.append(f"{part}: rank {r['rank']}'s norms or their "
                                "moments differ from rank 0's")
            if r[part]["losses"] != head[part]["losses"]:
                problems.append(f"{part}: the ranks' losses differ")
    if head["bf16"]["loss_abs_err"] > LOSS_ATOL:
        problems.append(f"bf16 loss {head['bf16']['losses'][0]} against one "
                        f"process's {head['bf16']['one_process_loss']}")
    agree = head["fp32"]["vs_one_process"]
    if agree["loss_rel_err"] > TPT_LOSS_RTOL:
        problems.append(f"fp32 loss off by {agree['loss_rel_err']}")
    grad_err = max(v for k, v in agree.items() if k.startswith("grad_err"))
    grad_cos = min(v for k, v in agree.items()
                   if k.startswith("grad_cosine"))
    if grad_err > TPT_GRAD_TOL or grad_cos < TPT_GRAD_COSINE:
        problems.append(f"fp32 gradients: largest error {grad_err}, least "
                        f"cosine {grad_cos}")
    if agree["update_cosine"] < TPT_UPDATE_COSINE:
        problems.append(f"fp32 update cosine {agree['update_cosine']}")
    if problems:
        raise RuntimeError("tp train phase: " + "; ".join(problems))
    launches = {k: sum(r["bf16"]["launches"][k] for r in ranks)
                for k in FA_KERNELS}
    line = {"tp_train": {
        "world": len(ranks), "backend": head["backend"],
        "devices": [r["device"] for r in ranks], "layout": head["layout"],
        "gang_s": gang_s, "rank_part_s": [r["part_s"] for r in ranks],
        "card": card, "model": spec["preset"], "batch": spec["batch"],
        "seq": spec["seq"],
        "bf16": {**{k: [r["bf16"][k] for r in ranks] for k in (
                     "step_ms", "warmup_s", "collective_ms_per_step",
                     "collective_share", "peak_mem_gb", "launches")},
                 **{k: head["bf16"][k] for k in (
                     "layers", "heads_per_rank", "kv_heads_per_rank",
                     "losses", "one_process_loss", "loss_abs_err",
                     "collectives_per_step")},
                 "collectives_predicted": want_bf16,
                 "loss_atol": LOSS_ATOL,
                 "label": "two ranks on one card over gloo; not a TP "
                          "number"},
        "fp32": {"layers": spec["fp32_layers"], "attn": "dense",
                 **{k: head["fp32"][k] for k in (
                     "loss", "acc", "losses", "first_pass_collectives",
                     "collectives_per_step")},
                 "collectives_predicted": want_fp32,
                 "vs_one_process": {
                     **{k: v for k, v in agree.items()
                        if not k.startswith("grad_")},
                     "grad_err_max": grad_err, "grad_cosine_min": grad_cos,
                     "grad_err": {k[9:]: v for k, v in agree.items()
                                  if k.startswith("grad_err ")}},
                 "bounds": {"loss_rtol": TPT_LOSS_RTOL,
                            "grad": TPT_GRAD_TOL,
                            "grad_cosine": TPT_GRAD_COSINE,
                            "update_cosine": TPT_UPDATE_COSINE}},
        "replicated_bitwise_equal": True}}
    log(f"[tp_train] {json.dumps(line)}")
    return line, launches


def phase_tp_train_worker(card: str, steps=TPT_WORKER_STEPS,
                          extra=()) -> tuple:
    """Phase 17b: ``dist/longctx.yml``'s ``worker`` pods at tp=2, two
    ``worker llama-train --sp 1 --tp 2 --attn flash --out VOL`` processes
    under the rank contract (in ``build/tp_train_worker_smoke``),
    launched with ``--steps`` ``steps[0]``, ``steps[1]`` (both must
    resume at ``steps[0]``), then, with rank 1's newest step removed,
    ``steps[2]`` (both must resume at ``steps[0]`` again and end at the
    second launch's loss, bit for bit). Every launch: both ranks exit 0
    with one ``final_loss``, ``mesh`` tp 2, kernels 3-5 launched once a
    layer a step on each rank (the warm-up's too). The
    ``worker_tp_train`` line and {kernel: launches over every launch and
    rank}."""
    import math
    import shutil
    base = Path(__file__).resolve().parent / "build" / "tp_train_smoke"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0_phase = time.perf_counter()
    lt = ["llama-train", "--sp", "1", "--tp", "2", "--attn", "flash", *extra]
    on_card = "cpu" not in extra
    runs, problems, finals = [], [], []
    launches = {k: 0 for k in FA_KERNELS}
    for i, n in enumerate(steps):
        if i == 2:
            vol = base / "r1" / "vol"
            newest = sorted(d for d in os.listdir(vol)
                            if d.startswith("step-"))[-1]
            shutil.rmtree(vol / newest)
        t0 = time.perf_counter()
        res = _gang_worker_run([*lt, "--steps", str(n)], base, world=2)
        wall = time.perf_counter() - t0
        dones, resumed = [], []
        for r, (rc, events) in enumerate(res):
            done = [e for e in events if e.get("event") == "done"]
            if rc != 0 or not done:
                problems.append(f"launch {i} rank {r}: exit {rc}, "
                                f"{events[-2:]}")
                continue
            dones.append(done[0])
            resumed.append([e["step"] for e in events
                            if e.get("event") == "resumed"])
        runs.append({"steps": n, "wall_s": wall, "resumed": resumed,
                     "final_loss": [d["final_loss"] for d in dones],
                     "mesh": [d["mesh"] for d in dones],
                     "launches": [d.get("launches") for d in dones],
                     "collectives": [d.get("collectives") for d in dones],
                     "collective_s": [d.get("collective_s") for d in dones],
                     "peak_mem_gb": [d.get("peak_mem_gb") for d in dones]})
        if len(dones) != 2:
            continue
        want_resume = [] if i == 0 else [steps[0]]
        if any(r != want_resume for r in resumed):
            problems.append(f"launch {i}: resumed {resumed}, want "
                            f"{want_resume} on every rank")
        if len({d["final_loss"] for d in dones}) != 1 \
                or not math.isfinite(dones[0]["final_loss"] or math.nan):
            problems.append(f"launch {i}: final losses "
                            f"{[d['final_loss'] for d in dones]}")
        finals.append(dones[0]["final_loss"])
        if any(d["mesh"] != {"dp": 1, "sp": 1, "tp": 2} for d in dones):
            problems.append(f"launch {i}: mesh {dones[0]['mesh']}")
        ran = dones[0]["steps_run"] + 1          # and the warm-up
        for d in dones:
            got = d.get("launches") or {}
            if on_card and set(got.values()) != {ran * TPT_WORKER_LAYERS}:
                problems.append(f"launch {i}: kernel launches {got}, want "
                                f"{ran * TPT_WORKER_LAYERS} each")
            for k in launches:
                launches[k] += got.get(k, 0)
    if len(finals) == 3 and finals[1] != finals[2]:
        problems.append(f"the relaunch after rank 1 lost its newest step "
                        f"ends at {finals[2]}, the second launch at "
                        f"{finals[1]}")
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("tp train worker phase: " + "; ".join(problems))
    line = {"worker_tp_train": {
        "command": "2 x python -m dcos_commons_tpu_torch.frameworks.worker "
                   "llama-train --sp 1 --tp 2 --attn flash --out VOL under "
                   "JAX_COORDINATOR_ADDRESS/JAX_PROCESS_ID/"
                   f"JAX_NUM_PROCESSES, --steps {steps[0]}, then "
                   f"{steps[1]}, then {steps[2]} with rank 1's newest step "
                   "removed", "runs": runs,
        "wall_s": time.perf_counter() - t0_phase,
        "label": "two ranks on one card; not a TP speed", "card": card}}
    log(f"[worker_tp_train] {json.dumps(line)}")
    return line, launches


# --------------------------------------------------------------- phase 18

SPT_WORLD = 2
# 18a: an sp gang of SPT_WORLD ranks sharing the card over gloo trains
# llama_400m (phase 17a's width) on ONE sequence of SPT_SEQ positions
# (B=1, seed SEED), each rank holding SPT_SEQ / 2 of it through the
# embedding, the blocks and the loss, once for each attention of
# SPT_ATTNS: bf16 at full depth, a warm-up and SPT_BF16_STEPS timed
# step(s); then fp32 at SPT_FP32_LAYERS layers, held in rank 0 to one
# process of the port (dense attention over the whole sequence) on the
# same weights and tokens: the first step's loss within SPT_LOSS_RTOL,
# its gradient (reduced over sp) within SPT_GRAD_TOL of each leaf's
# largest with cosine >= SPT_GRAD_COSINE, and after SPT_FP32_STEPS steps
# the update by cosine >= SPT_UPDATE_COSINE. The bf16 warm-up loss within
# LOSS_ATOL of one process's. Bounds written before the first card run
# (PERF.md §6)
SPT_SEQ, SPT_BATCH = 8192, 1
SPT_ATTNS = (("ring", "contiguous"), ("ring", "zigzag"),
             ("ulysses", "contiguous"))
# bf16 also runs the global attention through kernels 3-5 (K/V gathered
# over sp, each rank's queries at their offset); the kernels take bf16
# only, so the fp32 check holds the three above
SPT_BF16_ATTNS = SPT_ATTNS + (("flash", "contiguous"),)
SPT_BF16_STEPS = 1
SPT_FP32_LAYERS, SPT_FP32_STEPS = 2, 2
SPT_LOSS_RTOL, SPT_GRAD_TOL, SPT_GRAD_COSINE = 1e-5, 1e-3, 0.9999
SPT_UPDATE_COSINE = 0.99
SPT_TIMEOUT_S = 900
# the card's sizes; a CPU rehearsal passes a smaller spec
SPT_SPEC = {"preset": "llama_400m", "cfg": {}, "batch": SPT_BATCH,
            "seq": SPT_SEQ, "fp32_layers": SPT_FP32_LAYERS}
# 18b: dist/longctx.yml's worker pods at the universe's defaults on a gang
# of 2 (--attn ring --ring-layout contiguous --seq 8192 --sp 0 --tp 0:
# sp=2), SPW_STEPS steps with a checkpoint each step: once through, then
# once preempted (SIGTERM to both ranks when both have checkpointed
# SPW_PREEMPT_AT) and relaunched; beside them --attn ulysses and
# --ring-layout zigzag at --seq SPW_SIDE_SEQ, and --sp 2 --tp 2 on 4 ranks
SPW_ARGS = ("llama-train", "--attn", "ring", "--ring-layout", "contiguous",
            "--seq", "8192", "--sp", "0", "--tp", "0", "--fused-ce", "true",
            "--grad-accum", "1", "--ckpt-every", "1")
SPW_STEPS, SPW_PREEMPT_AT = 4, 2
SPW_SIDE_SEQ, SPW_SIDE_STEPS = 2048, 2
SPW_SIDE = (("ulysses", 2, ("--attn", "ulysses")),
            ("zigzag", 2, ("--attn", "ring", "--ring-layout", "zigzag")),
            ("sp2tp2", 4, ("--attn", "ring", "--sp", "2", "--tp", "2")))


def sp_collectives_per_step(layers: int, attn: str,
                            sp: int = SPT_WORLD) -> int:
    """The collectives of one sp train step, from the code: per layer the
    attention's (the ring's ``sp - 1`` hops forward and ``sp`` back,
    Ulysses' two all-to-alls each way, the global attention's K/V gather
    and its reduce-scatter), the loss's mean over sp and its backward,
    then the one gradient reduction."""
    per_layer = {"ring": 2 * sp - 1, "ulysses": 4}.get(attn, 2)
    return layers * per_layer + 3


def _sp_case(attn: str, layout: str) -> str:
    return attn if layout == "contiguous" else f"{attn}_{layout}"


def sp_train_rank(device: str = "cuda", spec=SPT_SPEC) -> dict:
    """One rank of phase 18a (run by ``launch_local`` in a process of its
    own): ``MeshSpec(sp=world)``; for each attention of ``SPT_BF16_ATTNS``
    the bf16 steps at full depth (step ms, collectives and their host ms,
    peak memory, kernels 3-5's launches zeroed just before and read just
    after, every leaf's checksums), and for each of ``SPT_ATTNS`` the
    fp32 steps (the first
    step's gradient, reduced over sp, read from its first moment); in
    rank 0 one process's bf16
    loss and its fp32 loss, gradients and steps over the whole sequence
    on the same weights, and each attention's agreement with them.
    ``device`` ``"cpu"`` rehearses it on the CPU."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import llama, train
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MeshSpec(sp=dist.get_world_size()).build(device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    preset = getattr(llama.LlamaConfig, spec["preset"])
    seq = spec["seq"]
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "layout": mesh.layout, "part_s": {}, "bf16": {}, "fp32": {}}
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, preset(**spec["cfg"]).vocab_size,
        (spec["batch"], seq + 1)).astype(np.int32)).to(dev)

    def digest(trees) -> str:
        """Two checksums of each leaf's bits, taken on the device: the
        sum and a position-weighted sum (the leaves are replicated over
        sp, so any rank's differ only if a rank drifted)."""
        h = hashlib.sha1()
        for tree in trees:
            for _, t in sorted(_named(tree)):
                bits = t.detach().reshape(-1).view(
                    {2: torch.int16, 4: torch.int32}[t.element_size()]).long()
                w = torch.arange(1, bits.numel() + 1, device=dev) % 65521
                h.update(f"{int(bits.sum())} {int((bits * w).sum())};"
                         .encode())
        return h.hexdigest()

    def run(cfg, seed, n_steps, after_step=None, **opt_kw):
        """``n_steps`` from the seed's init; ``after_step(i, state, out)``
        sees each step's optimizer state and result."""
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
            mesh=mesh)
        opt = train.make_optimizer(**opt_kw)
        step = train.make_train_step(
            lambda p, b: llama.loss_fn(cfg, p, b, mesh), opt, mesh=mesh,
            batch_spec=None)
        state = train.init_opt_state(opt, params)
        losses, secs, counts, coll_s = [], [], [], []
        for i in range(n_steps):
            _sync(dev)
            c0, s0, t0 = mesh.collectives, mesh.collective_s, \
                time.perf_counter()
            params, state, o = step(params, state, toks)
            losses.append(float(o["loss"]))
            secs.append(time.perf_counter() - t0)
            counts.append(mesh.collectives - c0)
            coll_s.append(mesh.collective_s - s0)
            if after_step is not None:
                after_step(i, state, o)
        return params, state, losses, secs, counts, coll_s

    def clear():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # bf16 at full depth, one run per attention
    counters = [getattr(fa, k) for k in FA_KERNELS]
    for attn, layout in SPT_BF16_ATTNS:
        t0 = time.perf_counter()
        name = _sp_case(attn, layout)
        cfg = preset(max_seq=seq + 1, remat=False, attn_impl=attn,
                     ring_layout=layout, **spec["cfg"])
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.launches = 0
        params, state, losses, secs, counts, coll_s = run(
            cfg, SEED, 1 + SPT_BF16_STEPS, lr=3e-4, warmup=10,
            decay_steps=1000)
        launches = {k: c.launches for k, c in zip(FA_KERNELS, counters)}
        timed = slice(1, None)
        out["bf16"][name] = {
            "layers": cfg.n_layers, "losses": losses, "warmup_s": secs[0],
            "step_ms": float(np.mean(secs[timed])) * 1e3,
            "collectives_per_step": counts,
            "collective_ms_per_step": float(np.mean(coll_s[timed])) * 1e3,
            "collective_share": sum(coll_s[timed]) / sum(secs[timed]),
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if cuda else None),
            "launches": launches,
            "digest": digest((params, state.mu, state.nu))}
        del params, state
        clear()
        out["part_s"][f"bf16 {name}"] = time.perf_counter() - t0
    if mesh.rank == 0:
        cfg = preset(max_seq=seq + 1, remat=False, attn_impl="dense",
                     **spec["cfg"])
        whole = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        with torch.no_grad():
            out["bf16_one_process_loss"] = float(
                llama.loss_fn(cfg, whole, toks)[0])
        del whole
        clear()

    # fp32 at spec["fp32_layers"] layers; the clip is above the
    # gradient's norm, so the first update's mu is (1 - b1) times the
    # gradient (reduced over sp): the first pass is the first step
    seed32 = SEED + 18
    opt32 = dict(lr=3e-4, warmup=10, decay_steps=1000, grad_clip=1e9)

    def cfg32(attn, layout):
        return preset(max_seq=seq + 1, remat=False, attn_impl=attn,
                      ring_layout=layout, dtype=torch.float32,
                      **{**spec["cfg"], "n_layers": spec["fp32_layers"]})

    held = {}
    for attn, layout in SPT_ATTNS:
        t0 = time.perf_counter()
        name = _sp_case(attn, layout)
        first = {}

        def keep_first(i, state, o):
            if i == 0:
                first["grads"] = {n: mu / (1 - train.B1)
                                  for n, mu in _named(state.mu)}
                first["loss"], first["acc"] = (float(o["loss"]),
                                               float(o["metric"]))

        params, state, losses, _, counts, _ = run(
            cfg32(attn, layout), seed32, SPT_FP32_STEPS,
            after_step=keep_first, **opt32)
        out["fp32"][name] = {"loss": first["loss"], "acc": first["acc"],
                             "losses": losses, "collectives_per_step": counts,
                             "digest": digest((params, state.mu, state.nu))}
        if mesh.rank == 0:
            held[name] = (first["loss"], first["grads"],
                          {n: t for n, t in _named(params)})
        del params, state, first
        clear()
        out["part_s"][f"fp32 {name}"] = time.perf_counter() - t0
    if mesh.rank == 0:
        t0 = time.perf_counter()
        cfg = cfg32("dense", "contiguous")
        whole = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed32), device=dev)
        init = {n: t.clone() for n, t in _named(whole)}
        w_leaves = train._leaves(whole)
        for t in w_leaves:
            t.requires_grad_(True)
        w_loss, w_acc = llama.loss_fn(cfg, whole, toks)
        w_grads = dict(zip([n for n, _ in _named(whole)],
                           torch.autograd.grad(w_loss, w_leaves)))
        w_loss = float(w_loss.detach())
        for t in w_leaves:
            t.requires_grad_(False)
        opt = train.make_optimizer(**opt32)
        step = train.make_train_step(lambda p, b: llama.loss_fn(cfg, p, b),
                                     opt)
        state = train.init_opt_state(opt, whole)
        one_losses = []
        for _ in range(SPT_FP32_STEPS):
            whole, state, o = step(whole, state, toks)
            one_losses.append(float(o["loss"]))
        final = [t for _, t in _named(whole)]
        for name, (loss, grads, params) in held.items():
            err = {"loss_rel_err": abs(loss / w_loss - 1),
                   "one_process_loss": w_loss,
                   "one_process_acc": float(w_acc),
                   "one_process_losses": one_losses}
            for n, g in w_grads.items():
                err[f"grad_err {n}"] = _rel_max(grads[n], g)
                err[f"grad_cosine {n}"] = _cos(grads[n], g)
            d = update_agreement({"final": [params[n] for n in init]},
                                 {"init": list(init.values()),
                                  "final": final})
            err.update({"update_" + k: v for k, v in d.items()})
            out["fp32"][name]["vs_one_process"] = err
        del whole, state, init, w_grads, held
        clear()
        out["part_s"]["one_process"] = time.perf_counter() - t0
    return out


def phase_sp_train(card: str, dev="cuda", spec=SPT_SPEC) -> tuple:
    """Phase 18a: a gang of ``SPT_WORLD`` ranks sharing the card
    (:func:`sp_train_rank`): for each attention, every leaf bitwise equal
    on every rank after the steps (replicated over sp), one loss stream,
    the collectives a step against :func:`sp_collectives_per_step`, the
    bf16 warm-up loss against one process's, kernels 3-5 launched once a
    layer and step on each rank by the flash case and never by the
    others, and rank 0's fp32 agreement with one process within the
    bounds. Returns (the ``sp_train`` line, {kernel: the flash case's
    launches summed over the ranks})."""
    import math
    import torch
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    dev = torch.device(dev)
    t0 = time.perf_counter()
    ranks = launch_local(sp_train_rank, SPT_WORLD, dev.type, spec,
                         timeout_s=SPT_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    head = ranks[0]
    problems, cases = [], {}
    for attn, layout in SPT_BF16_ATTNS:
        name = _sp_case(attn, layout)
        b, f = head["bf16"][name], head["fp32"].get(name)
        parts = ("bf16", "fp32") if f else ("bf16",)
        want_b = sp_collectives_per_step(b["layers"], attn)
        want_f = sp_collectives_per_step(spec["fp32_layers"], attn)
        want_launches = (b["layers"] * (1 + SPT_BF16_STEPS)
                         if attn == "flash" else 0)
        for r in ranks:
            rb, rf = r["bf16"][name], r["fp32"].get(name)
            if rb["collectives_per_step"] != [want_b] * (1 + SPT_BF16_STEPS):
                problems.append(f"{name} rank {r['rank']} bf16 collectives "
                                f"{rb['collectives_per_step']}, want "
                                f"{want_b}")
            if rf and rf["collectives_per_step"] != [want_f] * SPT_FP32_STEPS:
                problems.append(f"{name} rank {r['rank']} fp32 collectives "
                                f"{rf['collectives_per_step']}, want "
                                f"{want_f}")
            if dev.type == "cuda" and set(rb["launches"].values()) != {
                    want_launches}:
                problems.append(f"{name} rank {r['rank']} kernel launches "
                                f"{rb['launches']}, want {want_launches} "
                                "each")
            if not all(math.isfinite(x) for x in rb["losses"]):
                problems.append(f"{name} rank {r['rank']} bf16 losses "
                                f"{rb['losses']}")
            for part in parts:
                if r[part][name]["digest"] != head[part][name]["digest"]:
                    problems.append(f"{name} {part}: rank {r['rank']}'s "
                                    "leaves differ from rank 0's")
                if r[part][name]["losses"] != head[part][name]["losses"]:
                    problems.append(f"{name} {part}: the ranks' losses "
                                    "differ")
        bf16_err = abs(b["losses"][0] - head["bf16_one_process_loss"])
        if bf16_err > LOSS_ATOL:
            problems.append(f"{name} bf16 loss {b['losses'][0]} against one "
                            f"process's {head['bf16_one_process_loss']}")
        cases[name] = {"bf16": {
            **{k: [r["bf16"][name][k] for r in ranks] for k in (
                "step_ms", "warmup_s", "collective_ms_per_step",
                "collective_share", "peak_mem_gb", "launches")},
            "losses": b["losses"],
            "collectives_per_step": b["collectives_per_step"],
            "collectives_predicted": want_b, "loss_abs_err": bf16_err}}
        if not f:
            continue
        agree = f["vs_one_process"]
        grad_err = max(v for k, v in agree.items()
                       if k.startswith("grad_err"))
        grad_cos = min(v for k, v in agree.items()
                       if k.startswith("grad_cosine"))
        if agree["loss_rel_err"] > SPT_LOSS_RTOL:
            problems.append(f"{name} fp32 loss off by "
                            f"{agree['loss_rel_err']}")
        if grad_err > SPT_GRAD_TOL or grad_cos < SPT_GRAD_COSINE:
            problems.append(f"{name} fp32 gradients: largest error "
                            f"{grad_err}, least cosine {grad_cos}")
        if agree["update_cosine"] < SPT_UPDATE_COSINE:
            problems.append(f"{name} fp32 update cosine "
                            f"{agree['update_cosine']}")
        cases[name]["fp32"] = {
            "loss": f["loss"], "acc": f["acc"], "losses": f["losses"],
            "collectives_per_step": f["collectives_per_step"],
            "collectives_predicted": want_f,
            "vs_one_process": {
                **{k: v for k, v in agree.items()
                   if not k.startswith("grad_")},
                "grad_err_max": grad_err, "grad_cosine_min": grad_cos}}
    if problems:
        raise RuntimeError("sp train phase: " + "; ".join(problems))
    flash = _sp_case("flash", "contiguous")
    launches = {k: sum(r["bf16"][flash]["launches"][k] for r in ranks)
                for k in FA_KERNELS}
    line = {"sp_train": {
        "world": len(ranks), "backend": head["backend"],
        "devices": [r["device"] for r in ranks], "layout": head["layout"],
        "gang_s": gang_s, "rank_part_s": [r["part_s"] for r in ranks],
        "card": card, "model": spec["preset"], "batch": spec["batch"],
        "seq": spec["seq"], "fp32_layers": spec["fp32_layers"],
        "bf16_one_process_loss": head["bf16_one_process_loss"],
        "cases": cases,
        "bounds": {"loss_atol_bf16": LOSS_ATOL, "loss_rtol": SPT_LOSS_RTOL,
                   "grad": SPT_GRAD_TOL, "grad_cosine": SPT_GRAD_COSINE,
                   "update_cosine": SPT_UPDATE_COSINE},
        "replicated_bitwise_equal": True,
        "label": "two ranks on one card over gloo; not an SP speed"}}
    log(f"[sp_train] {json.dumps(line)}")
    return line, launches


def _sp_worker_launch(args, base: Path, world: int, preempt_at=None):
    """One launch of ``world`` workers (:func:`_gang_worker_run`); with
    ``preempt_at``, SIGTERM to every rank at once when each has emitted
    its checkpoint of that step."""
    import signal
    if preempt_at is None:
        return _gang_worker_run(args, base, world=world)
    lock, ready, sent = threading.Lock(), {}, []

    def on_event(rank, proc, event):
        if event.get("event") == "checkpoint" \
                and event["step"] >= preempt_at:
            with lock:
                ready.setdefault(rank, proc)
                if len(ready) == world and not sent:
                    sent.append(True)       # once: a second one kills
                    for p in ready.values():
                        if p.poll() is None:
                            p.send_signal(signal.SIGTERM)

    return _gang_worker_run(args, base, world=world, on_event=on_event)


def phase_sp_train_worker(card: str, extra=()) -> dict:
    """Phase 18b (module constants above): the deployed defaults through
    (``full``), preempted at ``SPW_PREEMPT_AT`` (``preempted``) and
    relaunched (``resumed``), each run's ranks in ``build/sp_train_smoke``;
    beside them the ``SPW_SIDE`` gangs. Every other run: every rank exits
    0 with one ``final_loss`` and the reference's ``mesh``. Preempted: every
    rank exits, a rank with 143 having flushed its step, at least one
    such; the relaunch resumes every rank at one step at or past
    ``SPW_PREEMPT_AT`` and ends at the through run's loss bit for bit.
    ``extra`` goes last on every command line (a CPU rehearsal:
    ``--device cpu --seq 64``). The ``worker_sp_train`` line."""
    import math
    import shutil
    base = Path(__file__).resolve().parent / "build" / "sp_train_smoke"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0_phase = time.perf_counter()
    main = [*SPW_ARGS, *extra]
    contiguous = {"dp": 1, "sp": 2, "tp": 1, "ring_layout": "contiguous"}
    runs, problems = {}, []

    def record(name, res, wall, mesh, rcs=(0,)):
        dones = []
        for r, (rc, events) in enumerate(res):
            done = [e for e in events if e.get("event") == "done"]
            if rc not in rcs or not done:
                problems.append(f"{name} rank {r}: exit {rc}, {events[-2:]}")
                continue
            dones.append(done[0])
        runs[name] = {"wall_s": wall, "exit": [rc for rc, _ in res],
                      "resumed": [[e["step"] for e in ev
                                   if e.get("event") == "resumed"]
                                  for _, ev in res],
                      "final_loss": [d.get("final_loss") for d in dones],
                      "mesh": [d.get("mesh") for d in dones],
                      "steps_run": [d.get("steps_run") for d in dones],
                      "tokens_per_sec": [d.get("tokens_per_sec")
                                         for d in dones],
                      "collectives": [d.get("collectives") for d in dones],
                      "collective_s": [d.get("collective_s") for d in dones],
                      "peak_mem_gb": [d.get("peak_mem_gb") for d in dones]}
        if len(dones) != len(res):
            return dones
        if any(d["mesh"] != mesh for d in dones):
            problems.append(f"{name}: mesh {dones[0]['mesh']}, want {mesh}")
        if len({d.get("final_loss") for d in dones}) != 1:
            problems.append(f"{name}: final losses "
                            f"{[d.get('final_loss') for d in dones]}")
        return dones

    def chain():
        t0 = time.perf_counter()
        res = _sp_worker_launch([*main, "--steps", str(SPW_STEPS)],
                                base / "full", 2)
        full = record("full", res, time.perf_counter() - t0, contiguous)
        t0 = time.perf_counter()
        res = _sp_worker_launch([*main, "--steps", str(SPW_STEPS)],
                                base / "pre", 2, preempt_at=SPW_PREEMPT_AT)
        # each rank flushes at the first step boundary after the signal
        # (per rank, as the reference's sentinel): one that stops a step
        # before its peer leaves the peer's next collective to fail (exit
        # 1); either way the relaunch resumes at the newest step both hold
        flushed = [[e["flushed_step"] for e in ev
                    if e.get("event") == "preempted"] for _, ev in res]
        runs["preempted"] = {"wall_s": time.perf_counter() - t0,
                             "exit": [rc for rc, _ in res],
                             "flushed_step": flushed}
        if any(rc not in (143, 1) for rc, _ in res) or not any(
                rc == 143 and f for (rc, _), f in zip(res, flushed)):
            problems.append(f"preempted: exits {runs['preempted']['exit']}, "
                            f"flushed {flushed}")
        t0 = time.perf_counter()
        res = _sp_worker_launch([*main, "--steps", str(SPW_STEPS)],
                                base / "pre", 2)
        resumed = record("resumed", res, time.perf_counter() - t0,
                         contiguous)
        steps = runs["resumed"]["resumed"]
        if len({tuple(s) for s in steps}) != 1 or len(steps[0]) != 1 \
                or steps[0][0] < SPW_PREEMPT_AT:
            problems.append(f"resumed at {steps}, want one step >= "
                            f"{SPW_PREEMPT_AT} on every rank")
        if full and resumed and (
                full[0]["final_loss"] != resumed[0]["final_loss"]
                or not math.isfinite(full[0]["final_loss"] or math.nan)):
            problems.append(f"the relaunch ends at "
                            f"{resumed[0]['final_loss']}, the run through at "
                            f"{full[0]['final_loss']}")

    def side(name, world, args):
        def run():
            t0 = time.perf_counter()
            mesh = {"dp": world // 2 // (2 if "--tp" in args else 1),
                    "sp": 2, "tp": 2 if "--tp" in args else 1}
            if "ring" in args:
                mesh["ring_layout"] = ("zigzag" if "zigzag" in args
                                       else "contiguous")
            res = _sp_worker_launch(
                ["llama-train", *args, "--seq", str(SPW_SIDE_SEQ),
                 "--steps", str(SPW_SIDE_STEPS), *extra],
                base / name, world)
            record(name, res, time.perf_counter() - t0, mesh)
        return run

    _side_by_side(chain, *[side(*s) for s in SPW_SIDE])
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("sp train worker phase: " + "; ".join(problems))
    line = {"worker_sp_train": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(main) + f" --steps {SPW_STEPS} --out VOL on 2 "
                   "processes under JAX_COORDINATOR_ADDRESS/JAX_PROCESS_ID/"
                   "JAX_NUM_PROCESSES: through, then preempted (SIGTERM at "
                   f"step {SPW_PREEMPT_AT}) and relaunched; beside them "
                   + ", ".join(f"{n} ({w} ranks, --seq {SPW_SIDE_SEQ})"
                               for n, w, _ in SPW_SIDE),
        "runs": runs, "wall_s": time.perf_counter() - t0_phase,
        "label": "ranks sharing one card; not an SP speed", "card": card}}
    log(f"[worker_sp_train] {json.dumps(line)}")
    return line


# --------------------------------------------------------------- phase 19

EPP_WORLD = 2
# 19a: a gang of EPP_WORLD ranks sharing the card over gloo trains
# llama_400m's widths two ways on the tokens every rank holds: the MoE
# variant (each FFN replaced by EPP_MOE's experts) with the experts over
# ep, and the dense trunk in EPP_WORLD stages of EPP_N_MICRO microbatches
# over pp. Each in bf16 at full depth (a warm-up and EPP_BF16_STEPS timed
# steps), then in fp32 at EPP_FP32_LAYERS layers, held in rank 0 to one
# process of the port on the same weights and tokens (MoE: moe_apply_local
# over the whole batch; pipeline: the dense forward of the whole batch)
# with 18a's bounds: the first step's loss within EPP_LOSS_RTOL, its
# gradient (every leaf gathered whole) within EPP_GRAD_TOL of each
# leaf's largest with cosine >= EPP_GRAD_COSINE, and after
# EPP_FP32_STEPS steps the update by cosine >= EPP_UPDATE_COSINE; on
# every rank the replicated leaves bitwise equal. Bounds written before
# the first card run (PERF.md section 6)
EPP_EXPERTS = 8
EPP_MOE = {"num_experts": EPP_EXPERTS, "capacity_factor": 2.0,
           "routing": "top2"}
EPP_N_MICRO = 4
EPP_SEQ = 512                           # llama_400m's max_seq
EPP_ROWS = {"moe": 4, "pipe": 2 * EPP_N_MICRO}
EPP_BF16_STEPS = 2
EPP_FP32_LAYERS, EPP_FP32_STEPS = 2, 2
EPP_LOSS_RTOL, EPP_GRAD_TOL, EPP_GRAD_COSINE = (SPT_LOSS_RTOL, SPT_GRAD_TOL,
                                                SPT_GRAD_COSINE)
EPP_UPDATE_COSINE = SPT_UPDATE_COSINE
EPP_TIMEOUT_S = 900
# the card's sizes; a CPU rehearsal passes a smaller spec
EPP_SPEC = {"preset": "llama_400m", "cfg": {}, "seq": EPP_SEQ,
            "rows": EPP_ROWS, "fp32_layers": EPP_FP32_LAYERS}
EPP_KINDS = (("moe", "ep"), ("pipe", "pp"))
# 19b: the worker's llama-train --ep 2 and --pp 2 at its defaults on
# gangs of 2: --ep 2 through, then once preempted (SIGTERM to both ranks
# when both have checkpointed EPW_PREEMPT_AT; --ckpt-every 1) and
# relaunched, which must resume every rank at one step and end at the
# through run's loss bit for bit; --pp 2 through beside them
EPW_ARGS = {"ep": ("llama-train", "--ep", "2"),
            "pp": ("llama-train", "--pp", "2")}
EPW_STEPS, EPW_PREEMPT_AT = 20, 10      # the worker's default --steps
EPW_MESH = {"ep": {"dp": 1, "ep": 2, "experts": 4, "routing": "top2"},
            "pp": {"pp": 2, "microbatches": 2}}
# 19c: MoE serving on an ep gang of EPP_WORLD ranks. In process, fp32 at
# MOE_FP32_LAYERS layers of the 8B widths (dense decode attention: the
# kernels take bf16), phase 3's requests drained as phase 3 drains them:
# every stream token-equal to the one-device engine on the same weights
# (drained in rank 0's process after the gang's). Then dist/moe.yml's
# worker (WORKER_MOE_ARGS) as a gang of two at MOE_LAYERS layers
# (CUT_WORKER): the workers' 8 requests, each reply equal to phase 10's
# in-process engine's stream or held by phase 10's bf16 rule
# (moe_stream_share); kernel 1 launched on every rank while the gang
# served
EPS_TIMEOUT_S = 900


def epp_collectives_per_step(kind: str, layers: int, world: int = EPP_WORLD,
                             n_micro: int = EPP_N_MICRO) -> int:
    """The collectives of one ep or pp train step, from the code. MoE: a
    layer's two all-to-alls and its auxiliary loss's mean over ep, each
    way. Pipeline: ``n_micro + world - 2`` hops and the outputs' sum
    forward, the hops back and the input's "f" backward. Then the
    replicated leaves' reduction and the clip's norm (dp=1: no reduction
    of the sharded leaves)."""
    if kind == "moe":
        return 6 * layers + 2
    return 2 * (n_micro + world - 2) + 2 + 2


def epp_train_rank(device: str = "cuda", spec=EPP_SPEC) -> dict:
    """One rank of phase 19a (run by ``launch_local`` in a process of its
    own): for the MoE model over ``MeshSpec(ep=world)`` and the pipelined
    one over ``MeshSpec(pp=world)``, the bf16 steps at full depth (step
    ms, collectives and their host ms, peak memory, digests of the
    replicated leaves), and the fp32 steps with the first step's gradient
    (read from its first moment) and the final parameters gathered whole;
    in rank 0 one process's fp32 loss, gradients and steps on the same
    weights, and each model's agreement with them. ``device`` ``"cpu"``
    rehearses it on the CPU."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import llama, train
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    preset = getattr(llama.LlamaConfig, spec["preset"])
    moe_cfg = MoEConfig(**EPP_MOE)
    out = {"part_s": {}, "bf16": {}, "fp32": {}}
    for kind, axis in EPP_KINDS:
        mesh = MeshSpec(**{axis: world}).build(device)
        dev = mesh.device
        cuda = dev.type == "cuda"
        out.update(rank=mesh.rank, device=str(dev), backend=mesh.backend)
        toks = torch.from_numpy(np.random.default_rng(SEED + 19).integers(
            0, preset(**spec["cfg"]).vocab_size,
            (spec["rows"][kind], spec["seq"] + 1)).astype(np.int32)).to(dev)
        specs_of = (llama.moe_param_specs if kind == "moe"
                    else llama.pipeline_param_specs)
        # the dimension a sharded leaf is split on: the experts, the stages
        cut = 1 if kind == "moe" else 0

        def sharded(name):
            return (name.split("/")[-1] in ("w_in", "w_out") if kind == "moe"
                    else name.startswith("layers/"))

        def build(cfg, seed, one_process=False):
            gen = torch.Generator(device=dev).manual_seed(seed)
            if kind == "moe":
                return llama.init_moe_params(
                    cfg, EPP_EXPERTS, gen, device=dev,
                    mesh=None if one_process else mesh)
            params = llama.init_params(cfg, gen, device=dev)
            if one_process:
                return params
            return llama.shard_params(llama.stack_pipeline_params(
                params, world), mesh, cfg, specs_of(cfg))

        def loss_of(cfg, one_process=False):
            if kind == "moe":
                return lambda p, b: llama.loss_fn_moe(
                    cfg, p, b, None if one_process else mesh, moe_cfg)
            if one_process:
                return lambda p, b: llama.loss_fn(cfg, p, b)
            return lambda p, b: llama.loss_fn_pipelined(cfg, p, b, mesh,
                                                        EPP_N_MICRO)

        def whole(name, t):
            """The leaf whole, on every rank (a collective for a shard),
            in the one-process layout."""
            if not sharded(name):
                return t
            t = mesh.all_gather(t.contiguous(), axis, dim=cut)
            return t.flatten(0, 1) if kind == "pipe" else t

        def digest(trees) -> str:
            h = hashlib.sha1()
            for tree in trees:
                for name, t in sorted(_named(tree)):
                    if not sharded(name):
                        h.update(t.detach().float().cpu().numpy().tobytes())
            return h.hexdigest()

        def run(cfg, seed, n_steps, after_step=None, **opt_kw):
            params = build(cfg, seed)
            opt = train.make_optimizer(**opt_kw)
            step = train.make_train_step(
                loss_of(cfg), opt, mesh=mesh, batch_spec=None,
                param_spec_tree=specs_of(cfg))
            state = train.init_opt_state(opt, params)
            losses, secs, counts, coll_s = [], [], [], []
            for i in range(n_steps):
                _sync(dev)
                c0, s0, t0 = mesh.collectives, mesh.collective_s, \
                    time.perf_counter()
                params, state, o = step(params, state, toks)
                losses.append(float(o["loss"]))
                secs.append(time.perf_counter() - t0)
                counts.append(mesh.collectives - c0)
                coll_s.append(mesh.collective_s - s0)
                if after_step is not None:
                    after_step(i, state, o)
            return params, state, losses, secs, counts, coll_s

        def clear():
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        t0 = time.perf_counter()
        cfg = preset(max_seq=spec["seq"] + 1, remat=False, attn_impl="dense",
                     **spec["cfg"])
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        params, state, losses, secs, counts, coll_s = run(
            cfg, SEED, 1 + EPP_BF16_STEPS, lr=3e-4, warmup=10,
            decay_steps=1000)
        timed = slice(1, None)
        out["bf16"][kind] = {
            "layers": cfg.n_layers, "rows": spec["rows"][kind],
            "losses": losses, "warmup_s": secs[0],
            "step_ms": float(np.mean(secs[timed])) * 1e3,
            "collectives_per_step": counts,
            "collective_ms_per_step": float(np.mean(coll_s[timed])) * 1e3,
            "collective_share": sum(coll_s[timed]) / sum(secs[timed]),
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if cuda else None),
            "replicated": digest((params, state.mu, state.nu))}
        del params, state
        clear()
        out["part_s"][f"bf16 {kind}"] = time.perf_counter() - t0

        # fp32: the clip is above the gradient's norm, so the first
        # update's mu is (1 - b1) times the gradient
        t0 = time.perf_counter()
        seed32 = SEED + 19
        opt32 = dict(lr=3e-4, warmup=10, decay_steps=1000, grad_clip=1e9)
        cfg32 = preset(max_seq=spec["seq"] + 1, remat=False,
                       attn_impl="dense", dtype=torch.float32,
                       **{**spec["cfg"], "n_layers": spec["fp32_layers"]})
        first = {}

        def keep_first(i, state, o):
            if i == 0:
                first["grads"] = {n: whole(n, mu / (1 - train.B1))
                                  for n, mu in _named(state.mu)}
                first["loss"], first["acc"] = (float(o["loss"]),
                                               float(o["metric"]))

        params, state, losses, _, counts, _ = run(
            cfg32, seed32, EPP_FP32_STEPS, after_step=keep_first, **opt32)
        final = {n: whole(n, t) for n, t in _named(params)}
        out["fp32"][kind] = {"loss": first["loss"], "acc": first["acc"],
                             "losses": losses, "collectives_per_step": counts,
                             "replicated": digest((params, state.mu,
                                                   state.nu))}
        del params, state
        clear()
        if mesh.rank == 0:
            one = build(cfg32, seed32, one_process=True)
            init = {n: t.clone() for n, t in _named(one)}
            leaves = train._leaves(one)
            for t in leaves:
                t.requires_grad_(True)
            w_loss, w_acc = loss_of(cfg32, True)(one, toks)
            w_grads = dict(zip([n for n, _ in _named(one)],
                               torch.autograd.grad(w_loss, leaves)))
            w_loss = float(w_loss.detach())
            for t in leaves:
                t.requires_grad_(False)
            step = train.make_train_step(loss_of(cfg32, True),
                                         train.make_optimizer(**opt32))
            state = train.init_opt_state(None, one)
            one_losses = []
            for _ in range(EPP_FP32_STEPS):
                one, state, o = step(one, state, toks)
                one_losses.append(float(o["loss"]))
            err = {"loss_rel_err": abs(first["loss"] / w_loss - 1),
                   "one_process_loss": w_loss,
                   "one_process_acc": float(w_acc),
                   "one_process_losses": one_losses}
            for n, g in w_grads.items():
                err[f"grad_err {n}"] = _rel_max(first["grads"][n], g)
                err[f"grad_cosine {n}"] = _cos(first["grads"][n], g)
            d = update_agreement({"final": [final[n] for n in init]},
                                 {"init": list(init.values()),
                                  "final": [t for _, t in _named(one)]})
            err.update({"update_" + k: v for k, v in d.items()})
            out["fp32"][kind]["vs_one_process"] = err
            del one, state, init, w_grads
        del first, final
        clear()
        out["part_s"][f"fp32 {kind}"] = time.perf_counter() - t0
    return out


def phase_ep_pp_train(card: str, dev="cuda", spec=EPP_SPEC) -> dict:
    """Phase 19a: a gang of ``EPP_WORLD`` ranks sharing the card
    (:func:`epp_train_rank`): for each model the replicated leaves
    bitwise equal on every rank, one loss stream, the collectives a step
    against :func:`epp_collectives_per_step`, finite bf16 losses, and
    rank 0's fp32 agreement with one process within the bounds. The
    ``ep_pp_train`` line."""
    import math
    import torch
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    dev = torch.device(dev)
    t0 = time.perf_counter()
    ranks = launch_local(epp_train_rank, EPP_WORLD, dev.type, spec,
                         timeout_s=EPP_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    head = ranks[0]
    problems, cases = [], {}
    for kind, axis in EPP_KINDS:
        b, f = head["bf16"][kind], head["fp32"][kind]
        want_b = epp_collectives_per_step(kind, b["layers"])
        want_f = epp_collectives_per_step(kind, spec["fp32_layers"])
        for r in ranks:
            rb, rf = r["bf16"][kind], r["fp32"][kind]
            if rb["collectives_per_step"] != [want_b] * (1 + EPP_BF16_STEPS):
                problems.append(f"{kind} rank {r['rank']} bf16 collectives "
                                f"{rb['collectives_per_step']}, want "
                                f"{want_b}")
            if rf["collectives_per_step"] != [want_f] * EPP_FP32_STEPS:
                problems.append(f"{kind} rank {r['rank']} fp32 collectives "
                                f"{rf['collectives_per_step']}, want "
                                f"{want_f}")
            if not all(math.isfinite(x) for x in rb["losses"]):
                problems.append(f"{kind} rank {r['rank']} bf16 losses "
                                f"{rb['losses']}")
            for part, got in (("bf16", rb), ("fp32", rf)):
                if got["replicated"] != head[part][kind]["replicated"]:
                    problems.append(f"{kind} {part}: rank {r['rank']}'s "
                                    "replicated leaves differ from rank "
                                    "0's")
                if got["losses"] != head[part][kind]["losses"]:
                    problems.append(f"{kind} {part}: the ranks' losses "
                                    "differ")
        agree = f["vs_one_process"]
        grad_err = max(v for k, v in agree.items()
                       if k.startswith("grad_err"))
        grad_cos = min(v for k, v in agree.items()
                       if k.startswith("grad_cosine"))
        if agree["loss_rel_err"] > EPP_LOSS_RTOL:
            problems.append(f"{kind} fp32 loss off by "
                            f"{agree['loss_rel_err']}")
        if grad_err > EPP_GRAD_TOL or grad_cos < EPP_GRAD_COSINE:
            problems.append(f"{kind} fp32 gradients: largest error "
                            f"{grad_err}, least cosine {grad_cos}")
        if agree["update_cosine"] < EPP_UPDATE_COSINE:
            problems.append(f"{kind} fp32 update cosine "
                            f"{agree['update_cosine']}")
        cases[kind] = {
            "axis": axis,
            "bf16": {**{k: [r["bf16"][kind][k] for r in ranks] for k in (
                "step_ms", "warmup_s", "collective_ms_per_step",
                "collective_share", "peak_mem_gb")},
                "layers": b["layers"], "rows": b["rows"],
                "losses": b["losses"],
                "collectives_per_step": b["collectives_per_step"],
                "collectives_predicted": want_b},
            "fp32": {"loss": f["loss"], "acc": f["acc"],
                     "losses": f["losses"],
                     "collectives_per_step": f["collectives_per_step"],
                     "collectives_predicted": want_f,
                     "vs_one_process": {
                         **{k: v for k, v in agree.items()
                            if not k.startswith("grad_")},
                         "grad_err_max": grad_err,
                         "grad_cosine_min": grad_cos}}}
    if problems:
        raise RuntimeError("ep/pp train phase: " + "; ".join(problems))
    line = {"ep_pp_train": {
        "world": len(ranks), "backend": head["backend"],
        "devices": [r["device"] for r in ranks], "gang_s": gang_s,
        "rank_part_s": [r["part_s"] for r in ranks], "card": card,
        "model": spec["preset"], "seq": spec["seq"],
        "moe": EPP_MOE, "n_micro": EPP_N_MICRO,
        "fp32_layers": spec["fp32_layers"], "cases": cases,
        "bounds": {"loss_rtol": EPP_LOSS_RTOL, "grad": EPP_GRAD_TOL,
                   "grad_cosine": EPP_GRAD_COSINE,
                   "update_cosine": EPP_UPDATE_COSINE},
        "replicated_bitwise_equal": True,
        "label": "two ranks on one card over gloo; not an EP or PP speed"}}
    log(f"[ep_pp_train] {json.dumps(line)}")
    return line


def phase_ep_pp_worker(card: str, extra=(), steps=EPW_STEPS,
                       preempt_at=EPW_PREEMPT_AT) -> dict:
    """Phase 19b (module constants above), each run's ranks in
    ``build/ep_pp_worker``: ``--ep 2`` through, preempted and relaunched;
    ``--pp 2`` through beside them. Every run: every rank exits 0 with one
    ``final_loss`` and the reference's ``mesh``. Preempted: every rank
    exits, a rank with 143 having flushed its step, at least one such;
    the relaunch resumes every rank at one step at or past
    ``preempt_at`` and ends at the through run's loss bit for bit.
    ``extra`` goes last on every command line (a CPU rehearsal:
    ``--device cpu``). The ``worker_ep_pp`` line."""
    import math
    import shutil
    base = Path(__file__).resolve().parent / "build" / "ep_pp_worker"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0_phase = time.perf_counter()
    runs, problems = {}, []

    def record(name, res, wall, mesh):
        dones = []
        for r, (rc, events) in enumerate(res):
            done = [e for e in events if e.get("event") == "done"]
            if rc != 0 or not done:
                problems.append(f"{name} rank {r}: exit {rc}, {events[-2:]}")
                continue
            dones.append(done[0])
        runs[name] = {"wall_s": wall, "exit": [rc for rc, _ in res],
                      "resumed": [[e["step"] for e in ev
                                   if e.get("event") == "resumed"]
                                  for _, ev in res],
                      **{k: [d.get(k) for d in dones] for k in (
                          "final_loss", "mesh", "steps_run",
                          "tokens_per_sec", "collectives", "collective_s",
                          "peak_mem_gb")}}
        if len(dones) != len(res):
            return dones
        if any(d["mesh"] != mesh for d in dones):
            problems.append(f"{name}: mesh {dones[0]['mesh']}, want {mesh}")
        if len({d.get("final_loss") for d in dones}) != 1:
            problems.append(f"{name}: final losses "
                            f"{[d.get('final_loss') for d in dones]}")
        return dones

    def args_of(kind, *more):
        return [*EPW_ARGS[kind], "--steps", str(steps), *more, *extra]

    def chain():
        t0 = time.perf_counter()
        res = _gang_worker_run(args_of("ep"), base / "ep_full", EPP_WORLD)
        full = record("ep_full", res, time.perf_counter() - t0,
                      EPW_MESH["ep"])
        t0 = time.perf_counter()
        res = _sp_worker_launch(args_of("ep", "--ckpt-every", "1"),
                                base / "ep_pre", EPP_WORLD,
                                preempt_at=preempt_at)
        flushed = [[e["flushed_step"] for e in ev
                    if e.get("event") == "preempted"] for _, ev in res]
        runs["ep_preempted"] = {"wall_s": time.perf_counter() - t0,
                                "exit": [rc for rc, _ in res],
                                "flushed_step": flushed}
        if any(rc not in (143, 1) for rc, _ in res) or not any(
                rc == 143 and f for (rc, _), f in zip(res, flushed)):
            problems.append(f"ep_preempted: exits "
                            f"{runs['ep_preempted']['exit']}, flushed "
                            f"{flushed}")
        t0 = time.perf_counter()
        res = _gang_worker_run(args_of("ep", "--ckpt-every", "1"),
                               base / "ep_pre", EPP_WORLD)
        resumed = record("ep_resumed", res, time.perf_counter() - t0,
                         EPW_MESH["ep"])
        at = runs["ep_resumed"]["resumed"]
        if len({tuple(s) for s in at}) != 1 or len(at[0]) != 1 \
                or at[0][0] < preempt_at:
            problems.append(f"ep resumed at {at}, want one step >= "
                            f"{preempt_at} on every rank")
        if full and resumed and (
                full[0]["final_loss"] != resumed[0]["final_loss"]
                or not math.isfinite(full[0]["final_loss"] or math.nan)):
            problems.append(f"the ep relaunch ends at "
                            f"{resumed[0]['final_loss']}, the run through "
                            f"at {full[0]['final_loss']}")

    def pipe():
        t0 = time.perf_counter()
        res = _gang_worker_run(args_of("pp"), base / "pp_full", EPP_WORLD)
        record("pp_full", res, time.perf_counter() - t0, EPW_MESH["pp"])

    _side_by_side(chain, pipe)
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("ep/pp worker phase: " + "; ".join(problems))
    line = {"worker_ep_pp": {
        "command": "python -m dcos_commons_tpu_torch.frameworks.worker "
                   "llama-train --ep 2 | --pp 2 --out VOL on 2 processes "
                   "under JAX_COORDINATOR_ADDRESS/JAX_PROCESS_ID/"
                   "JAX_NUM_PROCESSES: --ep 2 through, then preempted "
                   f"(SIGTERM at step {preempt_at}, --ckpt-every 1) and "
                   "relaunched; --pp 2 through beside them",
        "steps": steps, "runs": runs,
        "wall_s": time.perf_counter() - t0_phase,
        "label": "ranks sharing one card; not an EP or PP speed",
        "card": card}}
    log(f"[worker_ep_pp] {json.dumps(line)}")
    return line


def ep_serve_rank(device: str = "cuda", queue=None, cfg_kw=None) -> dict:
    """One rank of phase 19c's in-process gang: ``MeshSpec(ep=world)``,
    the rank's experts of ``init_moe_params`` from the seed at
    ``cfg_kw`` (by default the 8B widths in fp32 at ``MOE_FP32_LAYERS``
    layers, dense decode attention), a dropless ``PagedServer`` over the
    mesh draining ``queue`` as phase 3 drains it: the streams, the
    rank's weight and peak GB, its collectives. Rank 0 then frees its
    shard and drains the same queue through the one-device engine on the
    whole weights (``one_device``), in this process of its own: the main
    process may be capturing CUDA graphs meanwhile."""
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MeshSpec(ep=dist.get_world_size()).build(device)
    dev = mesh.device
    cfg = llama.LlamaConfig.llama3_8b(**(cfg_kw or dict(
        max_seq=2048, n_layers=MOE_FP32_LAYERS, dtype=torch.float32,
        decode_attn="dense")))
    moe = dropless(MoEConfig(MOE_EXPERTS))

    def drain(m):
        params = llama.init_moe_params(
            cfg, MOE_EXPERTS, torch.Generator(device=dev).manual_seed(SEED),
            device=dev, mesh=m)
        srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                                  prefill_chunk=64, moe=moe, device=dev,
                                  mesh=m)
        wall, _ = drain_timed(srv, queue)
        return params, srv, wall

    params, srv, wall = drain(mesh)
    stats = srv.page_stats()
    out = {"rank": mesh.rank, "streams": {r["request_id"]: srv.finished[
        r["request_id"]] for r in queue}, "wall_s": wall,
        "weight_gb": _tree_gb(params), "collectives": mesh.collectives,
        "collective_s": mesh.collective_s,
        "w_in_shape": list(params["layers"]["w_in"].shape),
        "ep": stats["ep"], "graphs_off": stats["graphs_off"],
        "ledger_violations": len(srv.ledger_violations()),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None)}
    del params, srv
    gc.collect()
    if mesh.rank == 0:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _, one, out["one_device_wall_s"] = drain(None)
        out["one_device"] = {r["request_id"]: one.finished[r["request_id"]]
                             for r in queue}
    return out


def phase_ep_serve_fp32(card: str, dev="cuda", cfg_kw=None,
                        vocab=WORKER_VOCAB) -> dict:
    """Phase 19c, in process (:func:`ep_serve_rank`): every rank's fp32
    stream of phase 3's requests equal to the one-device engine's on the
    same weights; the ``ep_serve_fp32`` line. Its card work is in the
    gang's processes, so it may run beside this process's phases."""
    import torch
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    t0 = time.perf_counter()
    queue = serve_queue(vocab)
    ranks = launch_local(ep_serve_rank, EPP_WORLD, torch.device(dev).type,
                         queue, cfg_kw, timeout_s=EPS_TIMEOUT_S)
    gang_s = time.perf_counter() - t0
    want, problems = ranks[0]["one_device"], []
    for r in ranks:
        differ = {rid: next((i for i, (a, b) in enumerate(zip(got, want[
            rid])) if a != b), None) for rid, got in r["streams"].items()
            if got != want[rid]}
        if differ:
            problems.append(f"fp32 rank {r['rank']}: streams leave the "
                            f"one-device engine at {differ}")
        if r["ep"] != EPP_WORLD or r["graphs_off"] != "ep" \
                or r["ledger_violations"]:
            problems.append(f"fp32 rank {r['rank']}: ep {r['ep']}, graphs "
                            f"off {r['graphs_off']}, ledger "
                            f"{r['ledger_violations']}")
    if problems:
        raise RuntimeError("ep serve phase: " + "; ".join(problems))
    line = {"ep_serve_fp32": {
        "layers": (cfg_kw or {}).get("n_layers", MOE_FP32_LAYERS),
        "experts": MOE_EXPERTS, "ep": EPP_WORLD,
        "streams_equal": len(queue), "of": len(queue), "gang_s": gang_s,
        "one_device_wall_s": ranks[0]["one_device_wall_s"],
        **{k: [r[k] for r in ranks] for k in (
            "wall_s", "weight_gb", "peak_mem_gb", "collectives",
            "collective_s", "w_in_shape")},
        "label": "two ranks on one card over gloo; not an EP speed",
        "card": card}}
    log(f"[ep_serve_fp32] {json.dumps(line)}")
    return line


def phase_ep_serve_worker(card: str, worker_want: dict,
                          dev="cuda") -> tuple:
    """Phase 19c, the workers: dist/moe.yml's replica as a gang of two
    (``WORKER_MOE_ARGS`` at ``MOE_LAYERS`` layers through ``CUT_WORKER``),
    the workers' 8 requests, each reply equal to ``worker_want`` (phase
    10's in-process streams on the same weights) or held by phase 10's
    bf16 rule (:func:`moe_stream_share`); kernel 1 launched on every rank
    while the gang served. Returns (the ``ep_serve_worker`` line,
    {kernel 1: launches over the ranks})."""
    import shutil
    import signal
    import torch
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    base = Path(__file__).resolve().parent / "build" / "ep_serve_worker"
    shutil.rmtree(base, ignore_errors=True)
    bodies = worker_bodies()
    args = (*WORKER_ARGS, *WORKER_MOE_ARGS)
    t0 = time.perf_counter()
    gang = _tp_worker_procs(base, args, MOE_LAYERS)
    try:
        serving_ev = [event("serving", WORKER_BOOT_S)
                      for _, _, event in gang]
        boot_s = time.perf_counter() - t0
        port = serving_ev[0]["port"]
        replies, errors, wall = _serve_over_http(port, bodies,
                                                 WORKER_STREAMED)
        stats = _http_get(port, "/v1/stats")
        beats = [gang[0][2]("heartbeat", 60,
                            lambda e: e.get("requests", 0) >= len(bodies))]
        it0 = stats.get("gang_iterations", 0)
        beats.append(gang[1][2]("heartbeat", 60,
                                lambda e: e.get("gang_iterations", 0)
                                >= it0))
    finally:
        rcs = [_sigterm(proc) for proc, _, _ in gang]
    problems = list(errors)
    launches = []
    paged = serving_ev[0].get("paged") or {}
    if paged.get("ep") != EPP_WORLD or paged.get("graphs_off") != "ep" \
            or (paged.get("moe") or {}).get("experts") != MOE_EXPERTS:
        problems.append(f"rank 0 page stats {paged}")
    for rank, (ev, beat) in enumerate(zip(serving_ev, beats)):
        if not (ev.get("gang") and ev.get("process_id") == rank):
            problems.append(f"rank {rank} serving event {ev}")
        if not beat.get("gang_iterations") or beat.get("gang_errors"):
            problems.append(f"rank {rank} heartbeat {beat}")
        launches.append(beat.get("launches", {}).get(
            "flash_decode_paged", 0) - ev.get("launches", {}).get(
            "flash_decode_paged", 0))
        if launches[-1] < 1 and torch.device(dev).type == "cuda":
            problems.append(f"rank {rank}: flash_decode_paged never "
                            "launched while the gang served")
    if any(rc != -signal.SIGTERM for rc in rcs):
        problems.append(f"exits {rcs}")
    got = {f"w{i}": (r or {}).get("tokens") for i, r in enumerate(replies)}
    if any(t is None or len(t) != 32 for t in got.values()):
        problems.append(f"replies {[len(t or []) for t in got.values()]}")
    shutil.rmtree(base, ignore_errors=True)
    if problems:
        raise RuntimeError("ep serve worker phase: " + "; ".join(problems))
    differ = [rid for rid in worker_want if got[rid] != worker_want[rid]]
    hold = None
    if differ:
        d = torch.device(dev)
        cfg = _moe_cfg(llama)
        params = llama.init_moe_params(
            cfg, MOE_EXPERTS, torch.Generator(device=d).manual_seed(SEED),
            device=d)
        prompts = {f"w{i}": b["prompt"] for i, b in enumerate(bodies)}
        hold = moe_stream_share(
            "MoE ep gang worker vs the in-process engine",
            {rid: got[rid] for rid in differ},
            {rid: worker_want[rid] for rid in differ}, prompts, cfg, params,
            llama.make_moe_ffn(cfg, dropless(MoEConfig(MOE_EXPERTS))))
        del params
        gc.collect()
        if d.type == "cuda":
            torch.cuda.empty_cache()
    n_tok = sum(len(t) for t in got.values())
    line = {"ep_serve_worker": {
        "command": "JAX_COORDINATOR_ADDRESS=127.0.0.1:P JAX_PROCESS_ID=r "
                   f"JAX_NUM_PROCESSES={EPP_WORLD} python -m "
                   "dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(args),
        "model": f"llama3_8b widths, {MOE_LAYERS} of 32 layers, "
                 f"{MOE_EXPERTS} experts top-2 dropless",
        "ep": EPP_WORLD, "boot_to_serving_s": boot_s,
        "weight_gb_per_rank": [e.get("weight_gb") for e in serving_ev],
        "requests": len(bodies), "tokens_out": n_tok, "wall_s": wall,
        "output_tok_s": n_tok / wall,
        "ttft_p50_ms": stats["ttft_ms"]["p50"],
        "tpot_p50_ms": stats["tpot_ms"]["p50"],
        "gang_iterations": [b["gang_iterations"] for b in beats],
        "collectives_per_rank": [b.get("collectives") for b in beats],
        "launches_flash_decode_paged_per_rank": launches,
        "peak_mem_gb_per_rank": [b.get("peak_mem_gb") for b in beats],
        "streams_equal_in_process": len(worker_want) - len(differ),
        "bf16_vs_in_process": hold,
        "label": "two ranks on one card over gloo; not an EP speed",
        "card": card}}
    log(f"[ep_serve_worker] {json.dumps(line)}")
    return line, {"flash_decode_paged": sum(launches)}


# --------------------------------------------------------------- phase 20

RING_WORLD = 2
RING_MAX_SEQ = 8192                     # dist/longctx.yml's SEQ_LEN
RING_ENGINE = dict(slots=8, page_size=64, prefill_chunk=64)
# request -> prompt tokens: one that pads to max_seq exactly (8,160 + 32
# new fill the table), one of about 3,000, one under the ring threshold
# (2 x 64), which prefills in chunks
RING_LENS = (("long", 8160), ("mid", 3000), ("short", 100))
RING_NEW = 32
RING_FP32_LAYERS = 4
RING_BF16_LAYERS = 8
# the fp32 ring's K/V of the long prompt against the one-device chunked
# engine's, as a share of the chunked pages' largest |value|
RING_KV_RTOL = 1e-4
RING_TIMEOUT_S = 900
RING_WORKER_ARGS = ("--pages", "-1", "--max-seq", str(RING_MAX_SEQ),
                    "--prefill-seq-parallel", "true")
RING_LABEL = "two ranks on one card over gloo; not an SP speed"


def ring_queue(v: int) -> list:
    """Phase 20's three requests from the seed (``RING_LENS``)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 20)
    return [{"prompt": _prompt(rng, n, v), "max_new": RING_NEW,
             "request_id": rid} for rid, n in RING_LENS]


def _written_digest(srv) -> tuple:
    """blake2s of every pool page but scratch that holds a nonzero byte
    (the pages the drain wrote), with their count: the pool is zeroed at
    construction, so two ranks that wrote the same pages alike agree."""
    import hashlib
    import torch
    h = hashlib.blake2s()
    k, v = srv.pool["k"][:, :-1], srv.pool["v"][:, :-1]
    written = ((k != 0).flatten(2).any(dim=(0, 2))
               | (v != 0).flatten(2).any(dim=(0, 2)))
    pages = torch.nonzero(written)[:, 0]
    for side in (k, v):
        h.update(side[:, pages].contiguous().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest(), int(pages.numel())


def _prompt_kv(srv, slot: int):
    """The K/V of ``slot``'s prompt positions, [2, L, n, KV, D], cloned
    on the device."""
    import torch
    n, ps = len(srv._prompts[slot]), srv.page_size
    pages = torch.tensor(srv._stream_pages[slot][:-(-n // ps)],
                         device=srv.device)
    kv = torch.stack([srv.pool["k"][:, pages], srv.pool["v"][:, pages]])
    return kv.flatten(2, 3)[:, :, :n].clone()


def ring_drain(srv, queue, long_id: str) -> dict:
    """Drain ``queue`` through the ring engine ``srv``, each ring prefill
    timed (synchronised) and the long prompt's K/V kept as the ring
    installed it, kernel 1's count zeroed just before and read just
    after."""
    from dcos_commons_tpu_torch.ops.flash_decode import flash_decode_paged
    dev = srv.device
    real, ring_s, kept = srv._ring_prefill, {}, {}

    def timed(slot):
        _sync(dev)
        t0 = time.perf_counter()
        ok = real(slot)
        _sync(dev)
        rid = srv.requests[slot].request_id
        ring_s[rid] = time.perf_counter() - t0
        if ok and rid == long_id:
            kept["kv"] = _prompt_kv(srv, slot)
        return ok

    srv._ring_prefill = timed
    flash_decode_paged.launches = 0
    c0 = srv.mesh.collectives
    t0 = time.perf_counter()
    got = srv.drain([dict(r) for r in queue], decode_window=8)
    _sync(dev)
    wall = time.perf_counter() - t0
    digest, pages = _written_digest(srv)
    stats = srv.page_stats()
    return {"streams": {r["request_id"]: got[r["request_id"]]
                        for r in queue},
            "wall_s": wall, "ring_s": ring_s,
            "launches": flash_decode_paged.launches,
            "collectives": srv.mesh.collectives - c0,
            "longctx": stats["longctx"], "sp": stats["sp"],
            "graphs_off": stats["graphs_off"],
            "graphs": srv.graph_stats()["graphs"],
            "ledger": len(srv.ledger_violations()), "digest": digest,
            "written_pages": pages, "kv": kept.get("kv")}


def one_device_chunked(cfg, params, queue, long_id: str, dev) -> dict:
    """The one-device chunked engine on the same weights: its streams,
    then, reset, the long prompt alone prefilled chunk by chunk
    (synchronised seconds) and its K/V."""
    from dcos_commons_tpu_torch.models import serving
    one = serving.PagedServer(cfg, params, device=dev, **RING_ENGINE)
    got = one.drain([dict(r) for r in queue], decode_window=8)
    one.reset()
    long = next(r for r in queue if r["request_id"] == long_id)
    slot = one.submit(long["prompt"], long["max_new"], long_id)
    _sync(dev)
    t0 = time.perf_counter()
    while one._prefill_q:
        one._prefill_tick()
    _sync(dev)
    return {"streams": {r["request_id"]: got[r["request_id"]]
                        for r in queue},
            "chunked_prefill_s": time.perf_counter() - t0,
            "kv": _prompt_kv(one, slot)}


def ring_serve_rank(device: str = "cuda", queue=None, stages=None,
                    long_id: str = "long") -> dict:
    """One rank of phase 20a's gang: ``MeshSpec(sp=world)``, the whole
    Llama weights from the seed at each stage's config (``stages``:
    {name: ``llama3_8b`` kwargs}; by default fp32 at
    ``RING_FP32_LAYERS`` layers with dense decode attention, then bf16 at
    ``RING_BF16_LAYERS``), a ``PagedServer(longctx_ring=world)`` draining
    ``queue`` (:func:`ring_drain`). Rank 0 then drains the same queue
    through the one-device chunked engine on the same weights
    (:func:`one_device_chunked`), in this process of its own: its
    streams, the long prompt's chunked prefill seconds and the largest
    K/V difference from the ring's pages."""
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MeshSpec(sp=dist.get_world_size()).build(device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    stages = stages or {
        "fp32": dict(max_seq=RING_MAX_SEQ, n_layers=RING_FP32_LAYERS,
                     dtype=torch.float32, decode_attn="dense"),
        "bf16": dict(max_seq=RING_MAX_SEQ, n_layers=RING_BF16_LAYERS)}
    out = {"rank": mesh.rank, "backend": mesh.backend}
    for name, kw in stages.items():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        cfg = llama.LlamaConfig.llama3_8b(**kw)
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        srv = serving.PagedServer(cfg, params, device=dev, mesh=mesh,
                                  longctx_ring=mesh.shape["sp"],
                                  **RING_ENGINE)
        res = ring_drain(srv, queue, long_id)
        ring_kv = res.pop("kv")
        res["weight_gb"] = _tree_gb(params)
        res["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                              if cuda else None)
        del srv
        gc.collect()
        if mesh.rank == 0:
            if cuda:
                torch.cuda.empty_cache()
            one = one_device_chunked(cfg, params, queue, long_id, dev)
            want = one.pop("kv")
            res["one_device"] = one
            res["kv_max_abs"] = float((ring_kv.float() - want.float())
                                      .abs().max())
            res["kv_scale"] = float(want.float().abs().max())
            del want
        out[name] = res
        del params, ring_kv
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def ring_gang(dev="cuda", stages=None, vocab=WORKER_VOCAB) -> dict:
    """Phase 20a's gang (:func:`ring_serve_rank`, two ranks sharing the
    card): its queue, its ranks' results and its seconds. It only waits
    on its processes here, so it runs beside phases of this process whose
    engines capture CUDA graphs; :func:`phase_ring_serve` checks it after."""
    import torch
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    t0 = time.perf_counter()
    queue = ring_queue(vocab)
    ranks = launch_local(ring_serve_rank, RING_WORLD,
                         torch.device(dev).type, queue, stages,
                         timeout_s=RING_TIMEOUT_S)
    return {"queue": queue, "ranks": ranks,
            "gang_s": time.perf_counter() - t0,
            "prompts": {r["request_id"]: r["prompt"] for r in queue},
            "bf16_streams": ranks[0]["bf16"]["streams"]}


def phase_ring_serve(card: str, gang: dict, dev="cuda", stages=None,
                     cfg=None) -> tuple:
    """Phase 20a's checks on :func:`ring_gang`'s results: in fp32 every
    rank's streams equal the one-device chunked engine's, the ranks'
    written pages bitwise equal, two ring prefills and no fallback, the
    long prompt's ring K/V within ``RING_KV_RTOL`` of the chunked
    engine's; in bf16 the same counters and pages, kernel 1 launched on
    each rank, and streams equal or held by phase 15's near-tie rule
    (teacher-forced here on the same weights, ``cfg`` the bf16 stage's
    config). Returns (the ``ring_serve`` line, {kernel 1: launches over
    the ranks})."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    queue, ranks, gang_s = gang["queue"], gang["ranks"], gang["gang_s"]
    problems = []
    lead = ranks[0]
    for stage in lead:
        if stage in ("rank", "backend"):
            continue
        want = lead[stage]["one_device"]["streams"]
        for r in ranks:
            got = r[stage]
            ls = got["longctx"]
            if (ls["ring_prefills"] != 2 or ls["fallbacks"]
                    or ls["ring"] != RING_WORLD or got["ledger"]
                    or got["sp"] != RING_WORLD or got["graphs_off"]):
                problems.append(f"{stage} rank {r['rank']}: longctx {ls}, "
                                f"ledger {got['ledger']}, sp {got['sp']}, "
                                f"graphs off {got['graphs_off']}")
            if (got["digest"], got["written_pages"]) != (
                    lead[stage]["digest"], lead[stage]["written_pages"]):
                problems.append(f"{stage} rank {r['rank']}: written pages "
                                "differ from rank 0's")
            if stage == "fp32" and got["streams"] != want:
                problems.append(f"fp32 rank {r['rank']}: streams leave the "
                                "one-device engine at " + str({
                                    rid: next(i for i, (a, b) in enumerate(
                                        zip(t, want[rid])) if a != b)
                                    for rid, t in got["streams"].items()
                                    if t != want[rid]}))
            if (torch.device(dev).type == "cuda" and stage == "bf16"
                    and got["launches"] < 1):
                problems.append(f"bf16 rank {r['rank']}: flash_decode_paged "
                                "never launched")
            if any(t != lead[stage]["streams"][rid]
                   for rid, t in got["streams"].items()):
                problems.append(f"{stage} rank {r['rank']}: streams differ "
                                "from rank 0's")
    fp32 = lead.get("fp32")
    if fp32 is not None and not (
            fp32["kv_max_abs"] <= RING_KV_RTOL * fp32["kv_scale"]):
        problems.append(f"fp32 ring K/V {fp32['kv_max_abs']} from the "
                        f"chunked engine's, over {RING_KV_RTOL} of "
                        f"{fp32['kv_scale']}")
    if problems:
        raise RuntimeError("ring serve phase: " + "; ".join(problems))
    bf16 = lead["bf16"]
    want = bf16["one_device"]["streams"]
    divergences = []
    differ = {rid for rid, t in bf16["streams"].items() if t != want[rid]}
    if differ:
        d = torch.device(dev)
        cfg = cfg or llama.LlamaConfig.llama3_8b(max_seq=RING_MAX_SEQ,
                                                 n_layers=RING_BF16_LAYERS)
        params = llama.init_params(
            cfg, torch.Generator(device=d).manual_seed(SEED), device=d)
        prompts = {r["request_id"]: r["prompt"] for r in queue}
        divergences = stream_check(
            "bf16 ring gang vs the one-device chunked engine",
            {rid: bf16["streams"][rid] for rid in differ},
            {rid: want[rid] for rid in differ}, prompts, cfg, params)
        del params
        gc.collect()
        if d.type == "cuda":
            torch.cuda.empty_cache()

    def stage_line(name):
        s = lead[name]
        return {"layers": (stages or {}).get(name, {}).get(
                    "n_layers", {"fp32": RING_FP32_LAYERS,
                                 "bf16": RING_BF16_LAYERS}[name]),
                "streams_equal_one_device": sum(
                    t == s["one_device"]["streams"][rid]
                    for rid, t in s["streams"].items()),
                "ring_prefill_s_long_per_rank": [
                    r[name]["ring_s"]["long"] for r in ranks],
                "one_device_chunked_prefill_s_long":
                    s["one_device"]["chunked_prefill_s"],
                "ring_prefills": s["longctx"]["ring_prefills"],
                "ring_prefilled_tokens": s["longctx"]["ring_prefilled_tokens"],
                "fallbacks": s["longctx"]["fallbacks"],
                "written_pages_equal": s["written_pages"],
                "kv_max_abs": s["kv_max_abs"], "kv_scale": s["kv_scale"],
                **{k: [r[name][k] for r in ranks] for k in (
                    "wall_s", "weight_gb", "peak_mem_gb", "collectives",
                    "launches", "graphs")}}

    line = {"ring_serve": {
        "model": "llama3_8b widths", "max_seq": RING_MAX_SEQ,
        "prompts": dict(RING_LENS), "max_new": RING_NEW, "sp": RING_WORLD,
        "gang_s": gang_s,
        **{name: stage_line(name) for name in lead
           if name not in ("rank", "backend")},
        "bf16_divergences": divergences,
        "kv_rtol": RING_KV_RTOL, "label": RING_LABEL, "card": card}}
    log(f"[ring_serve] {json.dumps(line)}")
    return line, {"flash_decode_paged": sum(r["bf16"]["launches"]
                                            for r in ranks)}


def ring_worker_run(prompts: dict, worker_args=WORKER_ARGS,
                    layers=RING_BF16_LAYERS) -> dict:
    """Phase 20b's run: ``dist/longctx.yml``'s ``server`` pod as a gang of
    two (``worker_args`` + ``RING_WORKER_ARGS`` at ``layers`` layers
    through ``CUT_WORKER``) answering the long prompt over HTTP, each
    rank's heartbeat after it; no card work in this process, so it runs
    beside phases that capture CUDA graphs."""
    import shutil
    base = Path(__file__).resolve().parent / "build" / "ring_worker"
    shutil.rmtree(base, ignore_errors=True)
    args = (*worker_args, *RING_WORKER_ARGS)
    t0 = time.perf_counter()
    gang = _tp_worker_procs(base, args, layers)
    try:
        serving_ev = [event("serving", WORKER_BOOT_S)
                      for _, _, event in gang]
        boot_s = time.perf_counter() - t0
        port = serving_ev[0]["port"]
        t1 = time.perf_counter()
        reply = _http_generate(port, {"prompt": prompts["long"],
                                      "max_new": RING_NEW})
        wall = time.perf_counter() - t1
        stats = _http_get(port, "/v1/stats")
        beats = [event("heartbeat", 60, lambda e: (
            (e.get("pages") or {}).get("longctx", {}).get(
                "ring_prefills", 0) >= 1)) for _, _, event in gang]
    finally:
        rcs = [_sigterm(proc) for proc, _, _ in gang]
    shutil.rmtree(base, ignore_errors=True)
    return {"args": args, "layers": layers, "boot_s": boot_s,
            "serving": serving_ev, "events": [ev for _, ev, _ in gang],
            "reply": reply, "wall_s": wall, "stats": stats,
            "beats": beats, "rcs": rcs}


def phase_ring_worker(card: str, run: dict, prompts: dict, want: dict,
                      dev="cuda", cfg=None) -> tuple:
    """Phase 20b's checks on :func:`ring_worker_run`: the long request's
    reply is 20a's bf16 gang stream on the same weights (``want``), or one
    held by the near-tie rule; every rank's heartbeat shows
    ``pages.longctx`` with a ring prefill and no fallback, and kernel 1
    launched on each rank while the gang served. Returns (the
    ``ring_worker`` line, {kernel 1: launches over the ranks})."""
    import signal
    import torch
    from dcos_commons_tpu_torch.models import llama

    serving_ev, beats = run["serving"], run["beats"]
    problems, launches = [], []
    paged = serving_ev[0].get("paged") or {}
    if paged.get("sp") != RING_WORLD or paged.get("graphs_off") is not None \
            or (paged.get("longctx") or {}).get("ring") != RING_WORLD:
        problems.append(f"rank 0 page stats {paged}")
    for rank, (events, ev, beat) in enumerate(
            zip(run["events"], serving_ev, beats)):
        if not (ev.get("gang") and ev.get("process_id") == rank):
            problems.append(f"rank {rank} serving event {ev}")
        if any(e.get("event") == "longctx_fallback" for e in events):
            problems.append(f"rank {rank}: longctx_fallback")
        lc = beat["pages"]["longctx"]
        if lc["fallbacks"] or beat.get("gang_errors"):
            problems.append(f"rank {rank} heartbeat {lc}, errors "
                            f"{beat.get('gang_errors')}")
        launches.append(beat.get("launches", {}).get(
            "flash_decode_paged", 0) - ev.get("launches", {}).get(
            "flash_decode_paged", 0))
        if launches[-1] < 1 and torch.device(dev).type == "cuda":
            problems.append(f"rank {rank}: flash_decode_paged never "
                            "launched while the gang served")
    if any(rc != -signal.SIGTERM for rc in run["rcs"]):
        problems.append(f"exits {run['rcs']}")
    got = (run["reply"] or {}).get("tokens")
    if got is None or len(got) != RING_NEW:
        problems.append(f"reply {run['reply']}")
    if problems:
        raise RuntimeError("ring worker phase: " + "; ".join(problems))
    divergences = []
    if got != want["long"]:
        d = torch.device(dev)
        cfg = cfg or llama.LlamaConfig.llama3_8b(max_seq=RING_MAX_SEQ,
                                                 n_layers=run["layers"])
        params = llama.init_params(
            cfg, torch.Generator(device=d).manual_seed(SEED), device=d)
        divergences = stream_check(
            "ring worker gang vs 20a's gang", {"long": got},
            {"long": want["long"]}, prompts, cfg, params)
        del params
        gc.collect()
        if d.type == "cuda":
            torch.cuda.empty_cache()
    line = {"ring_worker": {
        "command": "JAX_COORDINATOR_ADDRESS=127.0.0.1:P JAX_PROCESS_ID=r "
                   f"JAX_NUM_PROCESSES={RING_WORLD} python -m "
                   "dcos_commons_tpu_torch.frameworks.worker "
                   + " ".join(run["args"]),
        "model": f"llama3_8b widths, {run['layers']} of 32 layers",
        "sp": RING_WORLD, "boot_to_serving_s": run["boot_s"],
        "prompt_tokens": len(prompts["long"]), "reply_s": run["wall_s"],
        "ttft_p50_ms": run["stats"]["ttft_ms"]["p50"],
        "equal_to_20a": got == want["long"], "divergences": divergences,
        "longctx_per_rank": [b["pages"]["longctx"] for b in beats],
        "launches_flash_decode_paged_per_rank": launches,
        "peak_mem_gb_per_rank": [b.get("peak_mem_gb") for b in beats],
        "weight_gb_per_rank": [e.get("weight_gb") for e in serving_ev],
        "label": RING_LABEL, "card": card}}
    log(f"[ring_worker] {json.dumps(line)}")
    return line, {"flash_decode_paged": sum(launches)}


def _kernel_entry(name, source, replaces, launches, cases, tolerance):
    """``launches``: {main path: count}; the entry's count is their sum."""
    head = cases[0]                        # the main path's shape
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "bound_share": head.get("bound_share"), "tolerance": tolerance,
            "cases": cases}


PHASE_S = {}


def timed_phase(name, fn, *args, **kw):
    """Run one phase and keep its wall seconds in ``PHASE_S``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        log(f"[phase] {name} {PHASE_S[name]:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 1
    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed_phase("1_build", phase_build)
    card = card_line()
    log(f"[card] {card}")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    decode_cases, slot_cases, fa_cases = timed_phase(
        "2_kernels", phase_kernels, flush)
    del flush
    torch.cuda.empty_cache()
    distill_line, distill_launches, distilled = timed_phase(
        "8_distill", phase_distill, card)
    serving_line, decode_launches, params, solo = timed_phase(
        "3_serve", phase_serve, card)
    torch.cuda.empty_cache()
    spec_line, spec_launches = timed_phase("7_spec", phase_spec, card,
                                           params, solo)
    artifact = save_spec_draft(params)
    gc.collect()
    torch.cuda.empty_cache()
    # 19a, then 19c's fp32 gang, beside 19b, all beside 11: their card
    # work is in their gangs' processes (peaks 19 GB, then 33, beside 11's
    # 22), mostly waiting on the host for gloo, and done before 11's worker
    ep_pp = {}
    ep_pp_done = _in_background(lambda: _side_by_side(
        lambda: ep_pp.update(
            train=phase_ep_pp_train(card),
            serve_fp32=phase_ep_serve_fp32(card)),
        lambda: ep_pp.update(worker=phase_ep_pp_worker(card))))
    kv_line, kv_launches, kv_rounds, kv_want = timed_phase(
        "11_kv_tiers", phase_kv_tiers, card, params)
    timed_phase("19a_19b_19c_fp32_after_11", ep_pp_done)
    ep_pp_train_line, ep_pp_worker_line = ep_pp["train"], ep_pp["worker"]
    ep_serve_fp32_line = ep_pp["serve_fp32"]
    gc.collect()
    torch.cuda.empty_cache()
    kv_worker_line, kv_worker_launches = timed_phase(
        "11_worker_kv_tiers", phase_kv_tier_worker, card, kv_rounds, kv_want)
    # 15a's gang beside 12 and 13a: its two ranks wait on the host for
    # their collectives (0.6 of a step) and hold 13 GB each; this
    # process's card work (12's and 13a's engines capture CUDA graphs,
    # which another thread's launches would break; 15a's checks after)
    # stays on this thread
    t0 = time.perf_counter()
    tp_gang_done = _in_background(lambda: tp_gang(solo))
    disagg_line, disagg_launches = timed_phase(
        "12_disagg", phase_disagg, card, params, solo)
    gc.collect()
    torch.cuda.empty_cache()
    migrate_line, migrate_launches = timed_phase(
        "13_migrate", phase_migrate, card, params, solo)
    gc.collect()
    torch.cuda.empty_cache()
    gang = timed_phase("15_tp_gang_after_13", tp_gang_done)
    log(f"[phase] 15_tp_gang {gang[1]:.1f} s, from 12's start "
        f"{time.perf_counter() - t0:.1f} s")
    tp_line, tp_launches = timed_phase("15_tp_checks", phase_tp, card,
                                       params, solo, gang=gang)
    gc.collect()
    torch.cuda.empty_cache()
    slots_line, slot_launches = timed_phase("5_serve_slots",
                                            phase_serve_slots, card, params)
    # the front door's handler closes over the front door, a cycle that
    # holds the engine until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    # the two workers side by side, each in its own directory: each run
    # is mostly its process's start and its weights' draw (21 GB each
    # beside phase 3's 16)
    worker_lines, worker_launches, replies, runs = [], {}, {}, {}
    build_dir = Path(__file__).resolve().parent / "build"
    timed_phase("6_worker_6_worker_paged", _side_by_side, *[
        (lambda w=w: runs.update({w[0]: phase_worker(
            card, *w, cwd=build_dir / f"worker_smoke_{w[0]}")}))
        for w in WORKER_ENGINES])
    for name, *_ in WORKER_ENGINES:
        line, launches, replies[name], _ = runs[name]
        worker_lines.append(line)
        worker_launches.update(launches)
    # 14b beside 16b and 14a's worker runs: the peer boot is host work
    # (hashing, copies, disk), the ResNet workers' runs mostly process
    # starts (14a's worker beside 16c's gang ran the card out of memory)
    side = {}
    timed_phase("14b_16b_14_worker_peer_worker_dp_worker_resnet",
                _side_by_side,
                lambda: side.update(peer=phase_peer_boot(card)),
                lambda: side.update(worker_dp=phase_dp_worker(card)),
                lambda: side.update(worker=phase_resnet_worker(card)))
    peer_line, peer_launches = side["peer"]
    dp_worker_line = side["worker_dp"]
    resnet_worker_line = side["worker"]
    # 15b beside 12's worker pair: both are worker processes on the card,
    # each counting its own kernels, mostly waiting on process starts
    timed_phase("15_worker_tp_12_worker_disagg", _side_by_side,
                lambda: side.update(tp=phase_tp_worker(card)),
                lambda: side.update(disagg=phase_disagg_worker(
                    card, replies["worker_paged"], params)))
    worker_tp_line, worker_tp_launches = side["tp"]
    disagg_worker_line, disagg_worker_launches = side["disagg"]
    fleet_line, fleet_launches = timed_phase("13_fleet", phase_fleet, card)
    try:
        # the two spec workers side by side, each in its own directory
        def spec_chain():
            t0 = time.perf_counter()
            side["spec"] = phase_spec_worker(card, artifact,
                                             replies["worker_paged"], params)
            side["spec_s"] = time.perf_counter() - t0

        timed_phase("7_worker_spec_8_worker_distilled", _side_by_side,
                    spec_chain,
                    lambda: side.update(distilled=phase_distill_serve(
                        card, distilled, replies["worker_paged"], params,
                        spec_line["accept_rate"])))
        spec_worker_s = side["spec_s"]
        spec_worker_line, spec_worker_launches = side["spec"]
        distilled_line, distilled_launches = side["distilled"]
    finally:
        import shutil
        shutil.rmtree(artifact["path"], ignore_errors=True)
        shutil.rmtree(Path(distilled).parent, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20's gang, then its worker pair, beside 10 and 4, once phase
    # 3's weights are freed (beside 13b the card ran out of memory): its
    # card work is in its own processes (peaks 17-19 GB a rank), mostly
    # waiting on the host for gloo; its checks, which may teacher-force on
    # the card, run here after
    def ring_chain():
        gang = ring_gang()
        return gang, ring_worker_run(gang["prompts"])

    t_ring = time.perf_counter()
    ring_done = _in_background(ring_chain)
    moe_line, moe_launches, moe_worker_want = timed_phase(
        "10_moe", phase_moe, card)
    gc.collect()
    torch.cuda.empty_cache()
    training_line, fa_launches = timed_phase("4_train", phase_train, card)
    gc.collect()
    torch.cuda.empty_cache()
    ring, ring_run = timed_phase("20a_20b_ring_after_4", ring_done)
    log(f"[phase] 20 ring {time.perf_counter() - t_ring:.1f} s from its "
        "start beside 10")
    ring_line, ring_launches = timed_phase("20a_checks", phase_ring_serve,
                                           card, ring)
    ring_worker_line, ring_worker_launches = timed_phase(
        "20b_checks", phase_ring_worker, card, ring_run, ring["prompts"],
        ring["bf16_streams"])
    gc.collect()
    torch.cuda.empty_cache()
    # 10's worker beside 14: the worker's run is mostly its process's
    # start and its weights' draw (38 GB beside 14's 14 GB), and neither
    # launches a kernel of this process that another phase counts
    moe_worker_done = _in_background(
        lambda: phase_moe_worker(card, moe_worker_want))
    # 19c's worker pair beside them (2 x 12 GB at 8 layers): processes
    # of their own, mostly waiting on the host for their all-to-alls
    ep_serve_done = _in_background(
        lambda: phase_ep_serve_worker(card, moe_worker_want))
    resnet_line = timed_phase("14_resnet", phase_resnet, card)
    moe_worker_line, moe_worker_launches = timed_phase(
        "10_worker_moe_after_14", moe_worker_done)
    ep_serve_worker_line, ep_serve_launches = timed_phase(
        "19c_worker_ep_serve_after_14", ep_serve_done)
    gc.collect()
    torch.cuda.empty_cache()
    # 17a beside 18a: both gangs wait on the host for their collectives
    # and fit the card together (peaks 7 and 25 GB a rank)
    side = {}
    timed_phase("17a_18a_tp_sp_train", _side_by_side,
                lambda: side.update(tpt=phase_tp_train(card)),
                lambda: side.update(spt=phase_sp_train(card)))
    tp_train_line, tp_train_launches = side["tpt"]
    sp_train_line, sp_train_launches = side["spt"]
    # 16a/16c beside 9's, 17b's and 18b's worker runs: the gang waits on
    # the host for its collectives, the workers' runs are mostly process
    # starts
    side = {}
    timed_phase("16_dp_9_llama_train_17b_18b_worker_tp_sp_train",
                _side_by_side,
                lambda: side.update(dp=phase_dp(card)),
                lambda: side.update(lt=phase_llama_train(card)),
                lambda: side.update(tpw=phase_tp_train_worker(card)),
                lambda: side.update(spw=phase_sp_train_worker(card)))
    dp_line, dp_launches = side["dp"]
    llama_train_line = side["lt"]
    tp_worker_line, tp_worker_launches = side["tpw"]
    sp_worker_line = side["spw"]
    ws = spec_worker_line["worker_spec"]
    spec_summary = {
        "windows": spec_line["windows"], "proposed": spec_line["proposed"],
        "accepted": spec_line["accepted"],
        "accept_rate_truncated": spec_line["accept_rate"],
        "accept_rate_self": spec_line["self_draft"]["accept_rate"],
        "fallbacks": spec_line["fallbacks"],
        "window_ms_graphed": spec_line["graphed_vs_eager"]["graph_window_ms"],
        "window_ms_eager": spec_line["graphed_vs_eager"]["eager_window_ms"],
        "tokens_per_target_pass":
            spec_line["graphed_vs_eager"]["tokens_per_target_pass"],
        "verify_share": spec_line["graphed_vs_eager"]["split"][
            "verify_share"],
        "draft_prefill_s": spec_line["draft_prefill_s"],
        "artifact_save_s": artifact["save_s"],
        "artifact_load_s": ws["spec_armed"]["load_s"],
        "artifact_bytes": artifact["bytes"],
        "worker_boot_s": ws["boot_to_serving_s"],
        "worker_phase_s": spec_worker_s,
        "worker_ttft_p50_ms": ws["ttft_p50_ms"],
        "worker_tpot_p50_ms": ws["tpot_p50_ms"],
        "worker_output_tok_s": ws["output_tok_s"],
        "near_tie_divergences": (len(spec_line["divergences"])
                                 + len(spec_line["self_draft"]["divergences"])
                                 + len(ws["divergences"])),
        "accept_rate_distilled":
            distilled_line["worker_distilled"]["accept_rate_distilled"],
        "engine": spec_line, "card": card}
    fa_tol = {"rtol": FA_RTOL,
              "atol": f"{FA_SCALED_ATOL} * max|plain| of each row of a head "
                      "(O) or of the tensor (gradients)",
              "lse_atol": LSE_ATOL}
    csrc = "dcos_commons_tpu_torch/csrc/"
    decode_tol = {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL}
    kernels = [
        _kernel_entry("flash_decode_paged", csrc + "flash_decode_paged.cu",
                      "dcos_commons_tpu/ops/flash_decode.py:263",
                      {"serving": decode_launches,
                       "worker_paged": worker_launches["flash_decode_paged"],
                       "spec": spec_launches["flash_decode_paged"],
                       "moe": moe_launches["flash_decode_paged"],
                       "worker_moe":
                           moe_worker_launches["flash_decode_paged"],
                       "kv_tiers": kv_launches,
                       "worker_kv_tiers":
                           kv_worker_launches["flash_decode_paged"],
                       "disagg": disagg_launches,
                       "worker_disagg":
                           disagg_worker_launches["flash_decode_paged"],
                       "migrate": migrate_launches,
                       "fleet": fleet_launches,
                       "worker_peer": peer_launches["flash_decode_paged"],
                       "tp": tp_launches["flash_decode_paged"],
                       "worker_ep_serve":
                           ep_serve_launches["flash_decode_paged"],
                       "ring": ring_launches["flash_decode_paged"],
                       "worker_ring":
                           ring_worker_launches["flash_decode_paged"]},
                      decode_cases,
                      decode_tol),
        _kernel_entry("flash_decode", csrc + "flash_decode_slots.cu",
                      "dcos_commons_tpu/ops/flash_decode.py:55",
                      {"serving_slots": slot_launches["flash_decode"],
                       "worker": worker_launches["flash_decode"],
                       "spec": spec_launches["flash_decode"],
                       "worker_spec": spec_worker_launches["flash_decode"],
                       "worker_distilled":
                           distilled_launches["flash_decode"],
                       "moe": moe_launches["flash_decode"],
                       "worker_moe": moe_worker_launches["flash_decode"],
                       "tp": tp_launches["flash_decode"],
                       "worker_tp": worker_tp_launches["flash_decode"]},
                      slot_cases, decode_tol),
        _kernel_entry("flash_attention_fwd", csrc + "flash_attention_fwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:62",
                      {"serving_slots": slot_launches["flash_attention_fwd"],
                       "worker": worker_launches["flash_attention_fwd"],
                       "spec": spec_launches["flash_attention_fwd"],
                       "worker_spec":
                           spec_worker_launches["flash_attention_fwd"],
                       "worker_distilled":
                           distilled_launches["flash_attention_fwd"],
                       "training": fa_launches["flash_attention_fwd"],
                       "distill": distill_launches["flash_attention_fwd"],
                       "distill_dp": dp_launches["flash_attention_fwd"],
                       "tp": tp_launches["flash_attention_fwd"],
                       "worker_tp":
                           worker_tp_launches["flash_attention_fwd"],
                       "train_tp": tp_train_launches["flash_attention_fwd"],
                       "train_sp": sp_train_launches["flash_attention_fwd"],
                       "worker_tp_train":
                           tp_worker_launches["flash_attention_fwd"]},
                      fa_cases["fwd"], fa_tol),
        _kernel_entry("flash_attention_bwd_dkdv",
                      csrc + "flash_attention_bwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:214",
                      {"training": fa_launches["flash_attention_bwd_dkdv"],
                       "distill":
                           distill_launches["flash_attention_bwd_dkdv"],
                       "distill_dp": dp_launches["flash_attention_bwd_dkdv"],
                       "train_tp":
                           tp_train_launches["flash_attention_bwd_dkdv"],
                       "train_sp":
                           sp_train_launches["flash_attention_bwd_dkdv"],
                       "worker_tp_train":
                           tp_worker_launches["flash_attention_bwd_dkdv"]},
                      fa_cases["dkdv"], fa_tol),
        _kernel_entry("flash_attention_bwd_dq",
                      csrc + "flash_attention_bwd.cu",
                      "dcos_commons_tpu/ops/flash_attention.py:256",
                      {"training": fa_launches["flash_attention_bwd_dq"],
                       "distill": distill_launches["flash_attention_bwd_dq"],
                       "distill_dp": dp_launches["flash_attention_bwd_dq"],
                       "train_tp": tp_train_launches["flash_attention_bwd_dq"],
                       "train_sp": sp_train_launches["flash_attention_bwd_dq"],
                       "worker_tp_train":
                           tp_worker_launches["flash_attention_bwd_dq"]},
                      fa_cases["dq"], fa_tol),
    ]
    sdpa = "scaled_dot_product_attention(attn_mask=kv_len, enable_gqa) over "
    kernels[0]["library"] = sdpa + "pre-gathered (dequantized) pages"
    kernels[1]["library"] = sdpa + "the (dequantized) slot cache"
    for k in kernels[2:]:
        k["library"] = ("scaled_dot_product_attention(is_causal, enable_gqa)"
                        + (" forward" if k["name"].endswith("fwd") else
                           " backward: dq, dk and dv together"))
    print(json.dumps(serving_line), flush=True)
    print(json.dumps(slots_line), flush=True)
    for line in worker_lines:
        print(json.dumps(line), flush=True)
    print(json.dumps(spec_worker_line), flush=True)
    print(json.dumps(distilled_line), flush=True)
    print(json.dumps(training_line), flush=True)
    print(json.dumps(distill_line), flush=True)
    print(json.dumps(llama_train_line), flush=True)
    print(json.dumps({"spec": spec_summary}), flush=True)
    print(json.dumps(moe_line), flush=True)
    print(json.dumps(moe_worker_line), flush=True)
    print(json.dumps(kv_line), flush=True)
    print(json.dumps(kv_worker_line), flush=True)
    print(json.dumps(disagg_line), flush=True)
    print(json.dumps(disagg_worker_line), flush=True)
    print(json.dumps(migrate_line), flush=True)
    print(json.dumps(fleet_line), flush=True)
    print(json.dumps(peer_line), flush=True)
    print(json.dumps(tp_line), flush=True)
    print(json.dumps(worker_tp_line), flush=True)
    print(json.dumps(resnet_line), flush=True)
    print(json.dumps(resnet_worker_line), flush=True)
    print(json.dumps(dp_line), flush=True)
    print(json.dumps(dp_worker_line), flush=True)
    print(json.dumps(tp_train_line), flush=True)
    print(json.dumps(tp_worker_line), flush=True)
    print(json.dumps(sp_train_line), flush=True)
    print(json.dumps(sp_worker_line), flush=True)
    print(json.dumps(ep_pp_train_line), flush=True)
    print(json.dumps(ep_pp_worker_line), flush=True)
    print(json.dumps(ep_serve_fp32_line), flush=True)
    print(json.dumps(ep_serve_worker_line), flush=True)
    print(json.dumps(ring_line), flush=True)
    print(json.dumps(ring_worker_line), flush=True)
    PHASE_S["total"] = time.perf_counter() - t_main
    PHASE_S["unaccounted"] = PHASE_S["total"] - sum(
        v for k, v in PHASE_S.items() if k != "total")
    print(json.dumps({"phase_s": PHASE_S}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
