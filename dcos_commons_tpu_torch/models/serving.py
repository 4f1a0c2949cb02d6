"""Continuous batching (port of ``SlotServer`` and ``PagedServer`` in
``dcos_commons_tpu/models/serving.py``).

* :class:`SlotServer`: a fixed pool of B slots shares one padded cache
  [L, B, max_seq, KV, D]; admission prefills a power-of-two bucket of
  prompts in one forward and scatters their K/V into free slots; one
  ``decode_step_slots`` advances every slot at its own length.
* :class:`PagedServer`: one device pool of fixed ``(page_size, KV, D)``
  K/V pages (+ one scratch page) serves every stream through a
  per-stream page table; admission is gated on pages free (the host
  ledger, ``models.paging.PagePool``); full prompt-prefix pages are
  shared through a radix with an eager copy-on-write of the boundary
  page; prompts prefill in fixed chunks, one chunk per decode step,
  interleaved with decode.

Differences from the reference, all mechanical:

* the ``lax.scan`` decode window is a Python loop of decode steps;
  tokens stay on the device and the window ends with ONE host transfer;
* on a CUDA device each window replays a CUDA graph, the counterpart of
  the reference's one jitted executable per window: ``SlotServer`` keeps
  one graph per window size ``k`` (the reference's ``_stepk_x[k]``),
  ``PagedServer`` one per ``(k, table width)`` (its kernel's span is the
  table's). A graph is captured at first use, or for the paged engine at
  :meth:`PagedServer.warmup`, after an eager run of the same window with
  every stream masked off, which leaves the lengths and tokens as they
  are and takes lazy initialisation (cuBLAS handles, the kernel
  libraries, the decode workspace) out of the capture. A capture error
  raises: there is no eager fallback on CUDA. On the CPU the window runs
  eagerly. Prefill, page copies and scatters stay eager;
* so the device tensors a window reads or writes are allocated once:
  the cache or pool, ``lengths``, ``cur_tok``, the active mask and the
  paged decode table. The host fills them with ``copy_`` and ``reset``
  zeroes them in place, so every captured graph stays valid;
* the cache and the pool are updated in place;
* a sampler draws from a ``torch.Generator`` (``generator=``), not a JAX
  key; a graph registers the engine's generator, so a sampled stream is
  the eager loop's stream for the same seed;
* speculative decoding (:meth:`PagedServer.arm_draft`): a window is k
  draft steps over the draft's own slot cache, the K-wide paged verify
  and the acceptance on the device, replayed on CUDA as one graph per
  ``(k, table width)`` from the same pool; ``reset`` zeroes the draft
  cache in place, since graphs bind it;
* MoE (``PagedServer(moe=...)``, the paged engine only, as in the
  reference): every decode step, prefill chunk and warm-up runs its FFN
  through ``llama.make_moe_ffn``: on one device the local path, every
  expert there (each captured window holds the routing), and over an
  ``ep`` mesh the expert-parallel one (below);
* the KV hierarchy (``PagedServer(tiers=..., directory=...,
  peer_fetch=...)``): an evicted radix page is gathered to the host (one
  device-to-host copy per side, ordered after every write in flight)
  and filed in a ``PageTierStore``; a hit promotes it back between
  windows, and a directory hit adopts a sibling's pages, both as an
  eager host-to-device ``index_copy_`` INTO the existing pool tensors,
  never a new pool, since every captured window binds the pool;
* disaggregation (:meth:`PagedServer.prefill_span`,
  :meth:`PagedServer.adopt_pages`): a foreign span installs with the same
  in-place ``index_copy_``, and the adopted stream's length and first
  token are written into the bound ``lengths`` and ``cur_tok``;
* live migration (:meth:`PagedServer.export_stream`,
  :meth:`PagedServer.import_stream`, :meth:`PagedServer.release_stream`):
  an exported stream's pages are gathered after every write in flight;
  an imported stream installs IN PLACE like an adopted span, with its
  length and last token written into the bound ``lengths`` and
  ``cur_tok``; the RNG state a stream carries is the engine
  generator's ``get_state()``, not a JAX key, and ``adopt_rng`` restores
  it into that same generator (the captured windows registered it);
* tensor parallelism (``mesh=``, a ``parallel.mesh.Mesh`` whose ``tp``
  axis spans a gang of processes, one device each): every rank holds its
  Megatron shard of the weights and its KV heads of the cache or pool
  (every slot and every page), and runs the same calls in the same order
  (``models.serving_gang`` broadcasts the intake); the ledger, the radix
  and the tables are host state, the same on every rank. The decode
  windows run eagerly under tp > 1: gloo cannot be captured, and the
  capture of an NCCL window waits for a machine with more than one card
  (``graph_stats()`` and ``page_stats()`` say ``graphs: false``, reason
  ``tp``). The paged engine refuses what it cannot take under tp > 1
  yet: a draft, ``moe=``, the KV hierarchy, disaggregation and
  migration (ROADMAP Queue 1 item 7). A mesh of one is no mesh;
* expert parallelism (``PagedServer(moe=..., mesh=...)``, a mesh whose
  ``ep`` axis spans the gang): every rank holds the whole weights and
  the whole pool but only its E/ep experts (``llama.shard_params``
  under ``llama.moe_param_specs``), runs the decode kernel over every
  head, and the MoE layer's two all-to-alls (``parallel.moe.moe_apply``)
  carry the experts' rows; windows run eagerly (reason ``ep``), and the
  engine refuses under ep what it refuses under tp, naming the axis;
* sequence-parallel prefill (``PagedServer(longctx_ring=n, mesh=...)``,
  a mesh whose ``sp`` axis of n spans the gang): every rank holds the
  whole weights and the whole pool. A prompt of at least
  ``ring_threshold`` tokens that starts at position 0 prefills in ONE
  tick through ``llama.prefill_ring``; each rank's K/V shard is gathered
  over sp and the whole span installs IN PLACE into every rank's pool,
  and the logits of the last position are handed from its rank to the
  others. Decode and chunked prefill carry no collective (the pool is
  whole everywhere and every rank decodes the same batch), so the
  windows replay CUDA graphs through kernel 1 as on one device. A
  padded length over ``max_seq`` (a pure function of the broadcast
  intake) falls back to chunks on every rank alike; a failure after the
  first collective raises :class:`RingPrefillError`, where the
  reference's catch-all falls back, since a rank that fell back while
  its peers ring would hang the gang. ``moe=``, ``kv_quant`` and tp are
  refused with the ring, and ``_refuse_mesh`` refuses under sp what it
  refuses under tp.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.flash_decode import flash_decode, flash_decode_paged
from ..ops.quant import QArray, QTensor, quantize
from ..ops.rotary import rope_frequencies
from ..ops.sampling import Sampler
from ..parallel.aot import CompileCache, engine_key
from ..parallel.mesh import Mesh, tp_size
from ..parallel.moe import MoEConfig
from ..parallel.ring_attention import ring_pad_len
from . import llama
from .paging import (PagePool, PageTierStore, PrefixDirectory, PrefixRadix,
                     chain_keys, page_hashes)


@dataclasses.dataclass
class _Request:
    request_id: Any
    prompt_len: int
    budget: int
    tokens: List[int]


def _bucket(n: int, lo: int = 8) -> int:
    """The power of two >= ``n`` (at least ``lo``) a prompt pads to."""
    b = lo
    while b < n:
        b *= 2
    return b


def _prefill_bucket_many(cfg: llama.LlamaConfig, params, prompts, true_lens,
                         rope, mesh: Optional[Mesh] = None):
    """[N, P] causal forward for N admitted prompts: (logits [N, V] fp32
    at each row's last live position ``true_lens - 1``, ks/vs
    [L, N, P, KV, D]). Positions past a row's length are causally
    downstream of its live ones and change nothing they read."""
    x, ks, vs = llama.prefill_trunk(cfg, params, prompts, rope, mesh)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, true_lens.long() - 1]
    return llama._lm_head(last, params, mesh), ks, vs


def _scatter_rows(cache: QArray, new: torch.Tensor,
                  slots: torch.Tensor) -> None:
    """Write prefill K/V [L, N, P, KV, D] into cache rows
    ``[:, slots[i], :P]`` in place, quantizing when the cache is int8.
    The slots are distinct free slots: no duplicate-index hazard."""
    p = new.shape[2]
    idx = slots.long()
    if isinstance(cache, QTensor):
        nq = quantize(new, axis=-1)
        cache.q[:, idx, :p] = nq.q
        cache.s[:, idx, :p] = nq.s.to(cache.s.dtype)
    else:
        cache[:, idx, :p] = new.to(cache.dtype)


# the kernel wrappers a decode window launches (a spec window: the slot
# kernel in its draft steps): a graph replay adds the launches its
# capture recorded to their counts
_WINDOW_KERNELS = (flash_decode, flash_decode_paged)


@dataclasses.dataclass
class _Window:
    """A captured decode window: its graph, the static output it writes
    (tokens [k, slots]; a spec window's [slots, k + 1]), and the kernel
    launches one replay makes."""
    graph: Any
    out: torch.Tensor
    launches: Tuple[int, ...]


def _zero_(kv: Dict[str, QArray]) -> None:
    """Zero a cache or pool in place (payload and scales)."""
    for t in kv.values():
        if isinstance(t, QTensor):
            t.q.zero_()
            t.s.zero_()
        else:
            t.zero_()


def _engine_mesh(mesh: Optional[Mesh], device: torch.device
                 ) -> Optional[Mesh]:
    """The mesh an engine keeps: None for no mesh or a mesh of one; a
    mesh whose device type differs from the engine's raises."""
    if mesh is None or mesh.size == 1:
        return None
    if mesh.device.type != device.type:
        raise ValueError(f"mesh rank drives {mesh.device}, the engine "
                         f"runs on {device}")
    return mesh


class RingPrefillError(RuntimeError):
    """A ring prefill that failed after its first collective. The gang's
    ranks may now disagree on the engine's state, so the replica fails
    (:class:`~dcos_commons_tpu_torch.models.serving_gang.
    GangServingDriver` lets it through)."""


def _refuse_mesh(engine, what: str, ep_ok: bool = False) -> None:
    """Raise for what a paged engine does not take on a mesh yet, naming
    the mesh's axes: nothing of it under tp > 1, and under ep (MoE
    serving, ``ep_ok`` for ``moe=`` itself) nothing but the MoE layer."""
    mesh = engine.mesh
    if mesh is None or (ep_ok and tp_size(mesh) == 1):
        return
    axes = ", ".join(f"{a}={n}" for a, n in mesh.shape.items() if n > 1)
    raise ValueError(f"{what} on a mesh over {axes} is not ported yet "
                     "(ROADMAP Queue 1 item 7)")


class _Engine:
    """What both engines share: the slot seams, token selection, the
    static decode state, the decode window (eager on the CPU, a CUDA
    graph per key on CUDA), the host side of a window and ``drain``. A
    subclass holds ``requests`` (None for a free slot), ``finished``,
    ``sampler`` and ``generator``, and defines ``submit_many``,
    ``step_many``, ``_maybe_retire`` and ``_step_logits``."""

    # set by the front door (``models.ingress.ServingFrontend``); the
    # engines record no spans of their own yet
    tracer = None

    def _init_decode_state(self) -> None:
        """The device tensors every window reads or writes, allocated
        once (a graph binds these very buffers), and the graph store."""
        dev = self.device
        self.lengths = torch.zeros((self.slots,), dtype=torch.int32,
                                   device=dev)
        self.cur_tok = torch.zeros((self.slots,), dtype=torch.int32,
                                   device=dev)
        self._mask = torch.zeros((self.slots,), dtype=torch.bool,
                                 device=dev)
        self._graphs: Dict[Any, _Window] = {}
        self._graph_pool = None
        self._capture_stream = None
        self.capture_s = 0.0              # seconds spent capturing
        # why windows run eagerly on CUDA (None: they replay graphs): a
        # window's collectives (tp, or ep's all-to-alls) cannot be
        # captured over gloo; an sp window has none (each rank decodes
        # its whole pool)
        self.graphs_off = next((a for a, n in self.mesh.shape.items()
                                if n > 1 and a != "sp"),
                               None) if self.mesh else None

    def _step_logits(self, lengths: torch.Tensor, tokens: torch.Tensor,
                     mp: Optional[int]) -> torch.Tensor:
        raise NotImplementedError

    def _window(self, k: int, mp: Optional[int]) -> torch.Tensor:
        """``k`` decode steps from the static lengths and tokens under
        the static mask: tokens [k, slots]. Masked-off streams keep their
        length and token. Ends by copying into ``lengths`` and
        ``cur_tok``, never by rebinding them."""
        ln, tok = self.lengths, self.cur_tok
        window = []
        for _ in range(k):
            logits = self._step_logits(ln, tok, mp)
            nxt = torch.where(self._mask, self._select(logits), tok)
            ln = torch.where(self._mask, ln + 1, ln)
            tok = nxt
            window.append(nxt)
        out = torch.stack(window)
        self.lengths.copy_(ln)
        self.cur_tok.copy_(tok)
        return out

    def _capture(self, key: Any, fn) -> _Window:
        """Capture the window ``fn`` (no arguments, returns the window's
        output tensor) as the graph of ``key`` in this engine's graph
        pool. First the same window runs eagerly on the capture stream
        with every stream masked off: lazy initialisation happens outside
        the capture, and no length or token advances (each stream
        rewrites the K/V row its next step writes, with the same values;
        rows past it are rewritten before they are read; the generator's
        state is put back)."""
        t0 = time.perf_counter()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        gen_state = (self.generator.get_state()
                     if self.generator is not None else None)
        self._mask.zero_()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        if gen_state is not None:
            self.generator.set_state(gen_state)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = [kern.launches for kern in _WINDOW_KERNELS]
        # thread_local: the front door's HTTP threads may run meanwhile
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
        # a capture launches nothing: its count moves to each replay
        launches = []
        for kern, n in zip(_WINDOW_KERNELS, before):
            launches.append(kern.launches - n)
            kern.launches = n
        win = self._graphs[key] = _Window(graph, out, tuple(launches))
        self.capture_s += time.perf_counter() - t0
        return win

    def _run_window(self, key: Any, active: List[int], fn) -> np.ndarray:
        """Run the window ``fn`` over the ``active`` streams (on CUDA the
        graph of ``key``, captured on first use) and bring its output to
        the host in ONE transfer."""
        mask = np.zeros((self.slots,), dtype=bool)
        mask[active] = True
        if self.device.type != "cuda" or self.graphs_off is not None:
            self._mask.copy_(torch.from_numpy(mask))
            return fn().cpu().numpy()
        win = self._graphs.get(key)
        if win is None:
            win = self._capture(key, fn)
        self._mask.copy_(torch.from_numpy(mask))
        win.graph.replay()
        for kern, n in zip(_WINDOW_KERNELS, win.launches):
            kern.launches += n
        return win.out.cpu().numpy()

    def graph_stats(self) -> Dict[str, Any]:
        """Captured windows: how many, their keys, the seconds spent
        capturing (eager pre-runs included) and the bytes the engine's
        graph pool holds on the device."""
        pool_bytes = 0
        if self._graph_pool is not None:
            pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) ==
                tuple(self._graph_pool))
        return {"graphs": len(self._graphs),
                "keys": sorted(self._graphs, key=repr),
                "capture_s": self.capture_s, "pool_bytes": pool_bytes,
                "enabled": (self.device.type == "cuda"
                            and self.graphs_off is None),
                "off_reason": self.graphs_off}

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    def requests_active(self) -> bool:
        return any(r is not None for r in self.requests)

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        return llama._select(self.sampler, self.generator, logits,
                             torch.int32)

    def _emit(self, host: np.ndarray, active: List[int]
              ) -> Dict[int, List[int]]:
        """Append a window's tokens ``host`` [k, slots] to the active
        requests, each cut at its retirement: a slot retired mid-window
        decoded the rest of it as dead compute."""
        out: Dict[int, List[int]] = {}
        for i in active:
            emitted: List[int] = []
            r = self.requests[i]
            for t in host[:, i]:
                emitted.append(int(t))
                r.tokens.append(int(t))
                self._maybe_retire(i)
                if self.requests[i] is None:
                    break
            out[i] = emitted
        return out

    def drain(self, queue: List[Dict[str, Any]],
              decode_window: int = 1) -> Dict[Any, List[int]]:
        """Serve a whole workload: submit as slots free up, step until
        every request finishes. Each queue item: {"prompt": [...],
        "max_new": int, "request_id": any}. ``decode_window > 1``
        amortizes the host round trip over a window of steps."""
        pending = list(queue)
        while pending or self.requests_active():
            placed = self.submit_many(pending)
            pending = pending[len(placed):]
            self.step_many(decode_window)
        return dict(self.finished)


class SlotServer(_Engine):
    """Fixed-slot continuous batching over one resident weight set.

    ``submit`` / ``submit_many`` place requests in free slots (bucketed
    prefill + first token); ``step`` advances every active slot by one
    token, ``step_many(k)`` by a window of ``k``; ``drain`` serves a
    whole queue. Greedy by default; pass ``sampler``
    (``ops.sampling.make_sampler``) and optionally ``generator`` for
    stochastic decoding.

    * **Deferred first token.** The prefill's first token stays on the
      device until the next engine entry point brings every such token
      over in ONE transfer (``_flush_pending``).
    * **Frozen retirees.** Retirement is host bookkeeping (budget, EOS or
      a full cache). Inside a window a retired slot's length and token
      stop advancing; its step rewrites one dead row (dropped once the
      length reaches ``max_seq``) that nothing reads until a prefill
      rewrites the slot.

    ``params`` must live on ``device``. Under ``mesh`` they are this
    rank's shard (``llama.shard_params``), the cache holds the rank's KV
    heads, and a sampler must draw the same on every rank (the same
    ``generator`` seed).
    """

    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, device: DeviceLike = "cuda",
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        llama.check_params_device(params, self.device, "engine")
        self.mesh = _engine_mesh(mesh, self.device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.sampler = sampler
        if sampler is not None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.eos_id = eos_id
        self._rope = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                      cfg.rope_theta, device=self.device)
        self.cache = llama.init_kv_cache(cfg, slots, cfg.max_seq,
                                         device=self.device, mesh=self.mesh)
        self._init_decode_state()
        self.finished: Dict[Any, List[int]] = {}
        self.reset()

    def reset(self) -> None:
        """Zero the device state in place and clear the slot bookkeeping
        (a failed step may leave the cache half-written); weights and
        captured graphs survive."""
        _zero_(self.cache)
        self.lengths.zero_()
        self.cur_tok.zero_()
        self.requests: List[Optional[_Request]] = [None] * self.slots
        self.finished.clear()
        # slot -> device scalar of the prefill's first token, awaiting
        # ONE batched host transfer (see _flush_pending)
        self._pending_first: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------ intake

    def submit(self, prompt: List[int], max_new: int = 32,
               request_id: Any = None) -> Optional[int]:
        """Prefill ``prompt`` into a free slot; returns the slot, or None
        when every slot is taken (the caller retries after a step)."""
        if not prompt:
            # must not alias the pool-full None: drain() would retry the
            # same item forever
            raise ValueError("empty prompt")
        self._flush_pending()
        free = self.free_slots()
        if not free:
            return None
        item = {"prompt": prompt, "max_new": max_new,
                "request_id": request_id}
        reason = self._validate_item(item)
        if reason is not None:
            raise ValueError(reason)
        # the reference's one-prompt prefill and scatter are the N=1 case
        # of the batched ones
        return self._submit_batch([item], free[:1])[0][0]

    def _validate_item(self, item: Dict[str, Any]) -> Optional[str]:
        """None when admissible, else the rejection reason: the one copy
        of the admission predicate."""
        prompt = item["prompt"]
        max_new = item.get("max_new", 32)
        if not prompt:
            return "empty prompt"
        if len(prompt) + max_new > self.cfg.max_seq:
            return (f"prompt {len(prompt)} + max_new {max_new} exceeds "
                    f"the cache ({self.cfg.max_seq}); raise max_seq or "
                    "shrink the ask")
        return None

    def submit_many(self, items: List[Dict[str, Any]],
                    on_invalid=None) -> List[Tuple[int, Any]]:
        """Admit up to ``len(free_slots())`` of ``items`` in power-of-two
        batches (largest first), each prefilled as ONE [N, P] forward
        whose K/V scatter into N distinct slots. Each item: {"prompt":
        [...], "max_new": int, "request_id": any}. Returns [(slot,
        request_id), ...] for what was admitted. Invalid items fail
        alone with ``on_invalid(item, reason)``; without it the first
        invalid item raises before any prefill."""
        admissible = []
        for item in items:
            reason = self._validate_item(item)
            if reason is None:
                admissible.append(item)
            elif on_invalid is not None:
                on_invalid(item, reason)
            else:
                raise ValueError(reason)
        self._flush_pending()
        placed: List[Tuple[int, Any]] = []
        remaining = admissible
        while remaining:
            free = self.free_slots()
            if not free:
                break
            n = min(len(remaining), len(free))
            k = 1 << (n.bit_length() - 1)          # largest pow2 <= n
            batch, remaining = remaining[:k], remaining[k:]
            placed.extend(self._submit_batch(batch, free[:k]))
        return placed

    def _submit_batch(self, batch: List[Dict[str, Any]],
                      slots: List[int]) -> List[Tuple[int, Any]]:
        k = len(batch)
        lens = [len(item["prompt"]) for item in batch]
        bucket = min(_bucket(max(lens)), self.cfg.max_seq)
        arr = np.zeros((k, bucket), np.int32)      # assembled on the host
        for i, item in enumerate(batch):
            arr[i, :lens[i]] = item["prompt"]
        dev = self.device
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        logits, ks, vs = _prefill_bucket_many(
            self.cfg, self.params, torch.from_numpy(arr).to(dev), lens_t,
            self._rope, self.mesh)
        slot_t = torch.tensor(slots, device=dev)
        _scatter_rows(self.cache["k"], ks, slot_t)
        _scatter_rows(self.cache["v"], vs, slot_t)
        toks = self._select(logits)
        self.lengths[slot_t] = lens_t
        self.cur_tok[slot_t] = toks
        placed = []
        for i, item in enumerate(batch):
            slot = slots[i]
            rid = item.get("request_id")
            rid = rid if rid is not None else object()
            self.requests[slot] = _Request(rid, lens[i],
                                           item.get("max_new", 32), [])
            self._pending_first[slot] = toks[i]
            placed.append((slot, rid))
        return placed

    def _flush_pending(self) -> None:
        """Bring every deferred first token to the host in ONE transfer
        and run the retirement checks that waited on it. Called at the
        top of every engine-thread entry point that may observe request
        state, never from ``free_slots`` / ``requests_active`` (the HTTP
        health thread reads those)."""
        if not self._pending_first:
            return
        items = sorted(self._pending_first.items())
        self._pending_first.clear()
        vals = torch.stack([t for _, t in items]).tolist()
        for (slot, _), tok in zip(items, vals):
            r = self.requests[slot]
            if r is None:
                continue                       # aborted before flush
            r.tokens.append(int(tok))
            self._maybe_retire(slot)

    # ------------------------------------------------------------- decode

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is not None]

    def step(self) -> Dict[int, int]:
        """Advance every active slot one token; returns {slot: token}."""
        return {slot: toks[0] for slot, toks in self._decode(1).items()}

    def step_many(self, k: int) -> Dict[int, List[int]]:
        """Advance every active slot ``k`` tokens, with ONE host transfer
        for the window; returns {slot: [tokens...]}, each cut at the
        slot's retirement. ``k <= 1`` is :meth:`step`."""
        return self._decode(max(k, 1))

    def _step_logits(self, lengths: torch.Tensor, tokens: torch.Tensor,
                     mp: Optional[int]) -> torch.Tensor:
        logits, _ = llama.decode_step_slots(
            self.cfg, self.params, self.cache, lengths, tokens,
            rope=self._rope, mesh=self.mesh)
        return logits

    def _decode(self, k: int) -> Dict[int, List[int]]:
        self._flush_pending()
        active = self._active()
        if not active:
            return {}
        host = self._run_window(k, active, lambda: self._window(k, None))
        return self._emit(host, active)

    # --------------------------------------------------------- retirement

    def _maybe_retire(self, slot: int) -> None:
        r = self.requests[slot]
        if r is None:
            return
        done = (len(r.tokens) >= r.budget
                or (self.eos_id is not None
                    and r.tokens[-1] == self.eos_id)
                or r.prompt_len + len(r.tokens) >= self.cfg.max_seq)
        if done:
            self.finished[r.request_id] = r.tokens
            self.requests[slot] = None

    def abort_active(self) -> int:
        """Drop every in-flight request without recording results;
        returns how many were dropped. Their cache rows need no cleanup:
        lengths mask them and the next prefill rewrites them."""
        dropped = 0
        for i, r in enumerate(self.requests):
            if r is not None:
                self.requests[i] = None
                dropped += 1
        self._pending_first.clear()
        return dropped


def _copy_page(cache, src: int, dst: int) -> None:
    """Copy pool page ``src`` -> ``dst`` across every layer (payload +
    scales for int8 pools), in place: the eager copy-on-write of a
    prefix-cached boundary page at admission."""
    if isinstance(cache, QTensor):
        cache.q[:, dst] = cache.q[:, src]
        cache.s[:, dst] = cache.s[:, src]
    else:
        cache[:, dst] = cache[:, src]


def _install_pages(cache, payload, phys: torch.Tensor) -> None:
    """Write span pages ``payload`` ``[L, N, page, KV, D]`` (a QTensor
    for int8 pools) into pool pages ``phys`` ``[N]`` IN PLACE: captured
    windows bind the pool tensors, so a promote must never rebind
    them."""
    if isinstance(cache, QTensor):
        cache.q.index_copy_(1, phys, payload.q)
        cache.s.index_copy_(1, phys, payload.s)
    else:
        cache.index_copy_(1, phys, payload)


def _payload_slice(side, a: int, b: int, like):
    """Span payload pages ``[a:b)`` on the pool's device in its dtypes
    (``like`` is the pool side), the value :func:`_install_pages`
    writes (QTensor for int8 pools)."""
    if isinstance(side, dict):
        return QTensor(side["q"][:, a:b].to(like.q.device, like.q.dtype),
                       side["s"][:, a:b].to(like.s.device, like.s.dtype))
    return side[:, a:b].to(like.device, like.dtype)


def _payload_shape(side) -> Tuple[int, ...]:
    return tuple((side["q"] if isinstance(side, dict) else side).shape)


class PagedServer(_Engine):
    """Block-paged, prefix-shared continuous batching.

    Drive surface: ``submit`` / ``submit_many`` / ``step`` /
    ``step_many`` / ``drain`` / ``reset`` / ``abort_active``, plus the
    ``requests`` / ``finished`` / ``free_slots`` seams and the ledger
    audit (``expected_refs`` / ``ledger_violations`` / ``page_stats``).

    * **Pages, not rows.** A request holds ``ceil((prompt + max_new) /
      page_size)`` pages, reserved in full at admission, so the table
      stays constant through decode.
    * **Chunked prefill.** One ``prefill_chunk`` slice per decode step.
    * **Prefix sharing.** The boundary page copies eagerly at admission,
      so every page a stream writes is private.
    * **Scratch page.** Streams that are idle, still prefilling or
      retired point their table rows at physical page ``total_pages``
      for the decode step; padded chunk positions write there too.
    * **Deferred first token.** The prefill's first token stays on the
      device; the stream turns decode-active at the next flush, so
      tokens land in emission order and an EOS or budget-1 first token
      decodes nothing.
    * **MoE.** ``moe=MoEConfig(...)`` with ``llama.init_moe_params``
      weights routes every FFN through the expert bank; each prefill
      chunk (padded rows included) and each decode step (all ``slots``
      rows, masked ones included) is one dispatch group, so streams
      match ``llama.generate_stepwise_moe`` only under
      ``parallel.moe.dropless``. A draft is refused.
    * **KV hierarchy.** With ``tiers`` every radix eviction demotes the
      victim's bytes to the :class:`~dcos_commons_tpu_torch.models.
      paging.PageTierStore`; with ``directory`` and ``peer_fetch``
      (``peer_fetch(holder, prompt_prefix) -> span or None``, e.g.
      ``models.disagg.fetch_prefix``) a miss adopts a sibling's cached
      prefix, published under ``replica_id``. Admission only PLANS a
      promote or an adoption; the stream sits out one step and the plan
      lands at the top of the next (:meth:`_tier_tick`), before any
      window runs. Everything enters the radix through
      :meth:`_radix_adopt`, which discards the chains' tier frames, so a
      chain lives in the radix or in the tiers, never both.
    * **Ring prefill.** ``longctx_ring=n`` over a mesh whose ``sp`` axis
      is n prefills a long prompt in one sequence-parallel tick
      (:meth:`_ring_prefill`; module doc); ``ring_threshold`` defaults
      to twice ``prefill_chunk``.

    ``params`` must live on ``device``.
    """

    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 pages: Optional[int] = None, page_size: int = 64,
                 prefill_chunk: int = 64, sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, prefix_cache: bool = True,
                 compile_cache: Optional[CompileCache] = None,
                 tiers: Optional[PageTierStore] = None,
                 directory: Optional[PrefixDirectory] = None,
                 replica_id: str = "", peer_fetch=None,
                 moe: Optional[MoEConfig] = None,
                 longctx_ring: int = 0, ring_threshold: Optional[int] = None,
                 device: DeviceLike = "cuda", mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = _engine_mesh(mesh, self.device)
        if moe is not None:
            _refuse_mesh(self, "moe=", ep_ok=True)
        # sequence-parallel prefill (class doc): the reference's checks,
        # and what the port does not build with the ring
        self._ring_sp = int(longctx_ring)
        if self._ring_sp > 1:
            sp_have = self.mesh.shape["sp"] if self.mesh is not None else 1
            if sp_have != self._ring_sp:
                raise ValueError(
                    f"longctx_ring={longctx_ring} needs a mesh with an 'sp' "
                    "axis of that size; got "
                    f"{dict(self.mesh.shape) if self.mesh else None}")
            if cfg.max_seq % self._ring_sp:
                raise ValueError(
                    f"longctx_ring={longctx_ring} must divide max_seq "
                    f"{cfg.max_seq} so padded prompts stay in-table")
            if cfg.kv_quant:
                raise ValueError(
                    "ring prefill installs bf16 K/V spans; kv_quant pools "
                    "are not supported with longctx_ring")
            if moe is not None:
                raise ValueError(
                    "longctx_ring with moe= is not built: each rank would "
                    "route its own shard of the prompt as a dispatch group "
                    "(the reference routes the whole prompt), and the "
                    "worker never arms both (longctx_with_moe)")
            if tp_size(self.mesh) > 1:
                raise ValueError(
                    f"longctx_ring under tp={tp_size(self.mesh)} is not "
                    "built: the reference's worker never arms it")
        self.ring_threshold = (int(ring_threshold)
                               if ring_threshold is not None
                               else 2 * prefill_chunk)
        for name, value in (("tiers=", tiers), ("directory=", directory),
                            ("peer_fetch=", peer_fetch)):
            if value is not None:
                _refuse_mesh(self, name)
        if page_size < 1 or cfg.max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq "
                f"{cfg.max_seq} (the page table is fixed-width)")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        # MoE: `moe` (a parallel.moe.MoEConfig) swaps the FFN of every
        # decode step, prefill chunk and warm-up for the routed expert
        # layer; the paged KV is untouched
        if moe is not None and "router" not in params["layers"]:
            raise ValueError(
                "moe config given but params carry no router; build "
                "them with llama.init_moe_params")
        if moe is None and "router" in params["layers"]:
            raise ValueError(
                "params carry a router but no moe config; pass "
                "moe=MoEConfig(...) so routing is explicit")
        self.moe = moe
        self._ffn = (llama.make_moe_ffn(cfg, moe, mesh=self.mesh)
                     if moe is not None else None)
        llama.check_params_device(params, self.device, "engine")
        self.cfg = cfg
        self.params = params
        self.slots = slots                     # concurrent stream cap
        self.page_size = page_size
        self.pages_per_stream = cfg.max_seq // page_size
        self.total_pages = (int(pages) if pages is not None
                            else slots * self.pages_per_stream)
        if self.total_pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got "
                             f"{self.total_pages}")
        self.prefill_chunk = prefill_chunk
        self.sampler = sampler
        if sampler is not None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.eos_id = eos_id
        # physical index total_pages is the SCRATCH page: never in the
        # ledger, never read unmasked
        self.scratch = self.total_pages
        # speculative decoding (arm_draft): the draft, its slot cache and
        # the counters, which survive a disarm
        self._draft = None
        self._draft_cache = None
        self._draft_rope = None
        self.draft_k = 0
        self.metrics = None
        self.spec_windows = 0          # armed dispatches
        self.spec_proposed = 0         # draft tokens offered to verify
        self.spec_accepted = 0         # draft tokens the target kept
        self.spec_fallbacks = 0        # windows that failed and disarmed
        self.spec_draft_prefill_s = 0.0
        self.spec_window_s = 0.0
        # the KV hierarchy (class doc) and its counters
        self.tiers = tiers
        self.directory = directory
        self.replica_id = replica_id or f"paged-{id(self):x}"
        self.peer_fetch = peer_fetch
        self.tier_demoted_pages = 0    # pages gathered out on eviction
        self.tier_promoted_pages = 0   # pages installed back from tiers
        self.tier_fallbacks = 0        # planned promotes that recomputed
        self.tier_promote_s = 0.0      # cumulative promote-install time
        self.directory_hits = 0        # admissions served by a sibling
        self.directory_fallbacks = 0   # stale hints -> recompute
        self.adopted_prefix_pages = 0  # pages installed from siblings
        self.exported_prefixes = 0     # prefix spans served to siblings
        # sequence-parallel prefill (_ring_prefill)
        self.ring_prefills = 0         # prompts prefilled by the ring
        self.ring_prefilled_tokens = 0
        self.ring_prefill_s = 0.0      # cumulative ring-prefill time
        self.longctx_fallbacks = 0     # ring prompts sent to chunks
        # disaggregation (prefill_span / adopt_pages)
        self.shipped_spans = 0         # spans this prefill tier produced
        self.adopted_spans = 0         # foreign spans installed here
        self.adopt_shared_pages = 0    # span pages the radix already held
        # live migration (export_stream / import_stream / release_stream)
        self.migrated_out = 0          # streams released to a survivor
        self.migrated_in = 0           # streams imported mid-decode
        # greedy engines at an identical (config, topology, geometry) key
        # share what carries no engine state, the rope table; each engine
        # captures its own graphs (parallel/aot.py). Sampled engines
        # bypass the cache, as in the reference
        ns = None
        if compile_cache is not None and sampler is None:
            extra: Dict[str, Any] = {}
            if moe is not None:
                # routing identity is engine identity, as in the reference
                extra.update(moe_experts=moe.num_experts,
                             moe_capacity=moe.capacity_factor,
                             moe_routing=moe.routing)
            ns = compile_cache.namespace(engine_key(
                cfg, self.mesh, device=self.device, kind="paged", slots=slots,
                pages=self.total_pages, page_size=page_size,
                prefill_chunk=prefill_chunk, **extra))
        if ns and "rope" in ns:
            self._rope = ns["rope"]
        else:
            self._rope = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                          cfg.rope_theta, device=self.device)
            if ns is not None:
                ns["rope"] = self._rope
        self._prefix_cache = prefix_cache
        self.pool = llama.init_page_pool(cfg, self.total_pages + 1,
                                         page_size, device=self.device,
                                         mesh=self.mesh)
        self._init_decode_state()
        # the decode table: one flat buffer whose leading slots x mp
        # entries are the contiguous [slots, mp] table of a window of
        # width mp
        self._table_buf = torch.full(
            (slots * self.pages_per_stream,), self.scratch,
            dtype=torch.int32, device=self.device)
        self.reset()

    def reset(self) -> None:
        """Zero the device state in place and rebuild the host state (a
        failed step may leave the pool half-written); captured graphs
        survive. The radix is rebuilt too: its cached K/V is gone. An
        armed draft's cache is zeroed in place as well (the reference
        re-allocates it; here the spec graphs bind it). Pending promote
        plans die with their streams; the tier FRAMES survive, still
        bit-valid byte copies, so the cold cache stays warm."""
        _zero_(self.pool)
        if self._draft_cache is not None:
            _zero_(self._draft_cache)
        self.lengths.zero_()
        self.cur_tok.zero_()
        self._table_buf.fill_(self.scratch)
        self.ledger = PagePool(self.total_pages, self.page_size)
        self.radix = (PrefixRadix(self.ledger) if self._prefix_cache
                      else None)
        self._tables = np.full((self.slots, self.pages_per_stream),
                               self.scratch, np.int32)
        self.requests: List[Optional[_Request]] = [None] * self.slots
        self.finished: Dict[Any, List[int]] = {}
        # stream -> device scalar of the prefill's first token, awaiting
        # ONE batched host transfer (see _flush_pending)
        self._pending_first: Dict[int, torch.Tensor] = {}
        self._stream_pages: List[List[int]] = [[] for _ in
                                               range(self.slots)]
        self._prompts: List[Optional[List[int]]] = [None] * self.slots
        self._prefill_pos = [0] * self.slots   # next position to prefill
        self._prefill_q: "deque[int]" = deque()
        self._decoding = [False] * self.slots  # prefill finished?
        # promote/adoption plans admission queued for _tier_tick
        self._pending_tier: List[Dict[str, Any]] = []

    # ------------------------------------------------------------ intake

    def pages_free(self) -> int:
        return self.ledger.free_count()

    def _validate_item(self, item: Dict[str, Any]) -> Optional[str]:
        """None when admissible, else the rejection reason."""
        prompt = item["prompt"]
        max_new = item.get("max_new", 32)
        if not prompt:
            return "empty prompt"
        if len(prompt) + max_new > self.cfg.max_seq:
            return (f"prompt {len(prompt)} + max_new {max_new} exceeds "
                    f"the cache ({self.cfg.max_seq}); raise max_seq or "
                    "shrink the ask")
        need = -(-(len(prompt) + max_new) // self.page_size)
        if need > self.total_pages:
            # permanently infeasible: reject loudly, never queue
            return (f"prompt {len(prompt)} + max_new {max_new} needs "
                    f"{need} pages but the pool holds "
                    f"{self.total_pages}; raise pages or shrink the ask")
        return None

    def submit(self, prompt: List[int], max_new: int = 32,
               request_id: Any = None) -> Optional[int]:
        """Admit ``prompt``: reserve its FULL page span (prompt +
        max_new), share any cached full-prefix pages, copy the boundary
        page, and queue the uncached tail for chunked prefill. Returns
        the stream index, or None when streams or pages are exhausted.
        No forward runs here: prefill is paid one chunk per step."""
        reason = self._validate_item({"prompt": prompt,
                                      "max_new": max_new})
        if reason is not None:
            raise ValueError(reason)
        self._flush_pending()
        return self._admit(list(prompt), max_new, request_id)

    def submit_many(self, items: List[Dict[str, Any]],
                    on_invalid=None) -> List[Tuple[int, Any]]:
        """Admit a FIFO PREFIX of ``items`` (the first stream or page
        exhaustion stops intake, so a blocked head is never starved).
        Each item: {"prompt": [...], "max_new": int, "request_id": any}.
        Invalid items fail alone with ``on_invalid(item, reason)``;
        without it the first invalid item raises before any admission."""
        admissible = []
        for item in items:
            reason = self._validate_item(item)
            if reason is None:
                admissible.append(item)
            elif on_invalid is not None:
                on_invalid(item, reason)
            else:
                raise ValueError(reason)
        self._flush_pending()
        placed: List[Tuple[int, Any]] = []
        for item in admissible:
            slot = self._admit(list(item["prompt"]),
                               item.get("max_new", 32),
                               item.get("request_id"))
            if slot is None:
                break
            placed.append((slot, self.requests[slot].request_id))
        return placed

    # ------------------------------------------------------- KV hierarchy

    def _evict(self, need: int) -> int:
        """THE single release path for radix pages under pressure: a
        tiered engine demotes each victim's bytes BEFORE its reference
        drops."""
        demoter = self._demote if self.tiers is not None else None
        return self.radix.evict(need, demoter=demoter)

    def _demote(self, page: int, prefix_tokens: List[int]) -> None:
        """Demoter callback (``PrefixRadix.evict``): gather the victim's
        device bytes and file them under the prefix's chain key while
        the page still holds its last reference. Best-effort: a failed
        gather loses the cold copy, never the evict."""
        try:
            hs = page_hashes(prefix_tokens, self.page_size)
            ck = chain_keys(prefix_tokens, self.page_size)
            self.tiers.put(ck[-1], {
                "chain": ck[-1], "page_hash": hs[-1],
                "kv_quant": bool(self.cfg.kv_quant),
                "payload": self._gather_span([page])})
            self.tier_demoted_pages += 1
        except Exception:
            pass

    def _radix_adopt(self, prompt: List[int], pages: List[int]) -> int:
        """THE single adopt path into the radix: insert, then discard the
        tier frames of the re-acquired chains (one owner) and publish
        the chains to the prefix directory."""
        adopted = self.radix.insert(prompt, pages)
        full = min(len(prompt) // self.page_size, len(pages))
        if full and (self.tiers is not None or self.directory is not None):
            cks = chain_keys(prompt[:full * self.page_size],
                             self.page_size)
            if self.tiers is not None:
                for ck in cks:
                    self.tiers.discard(ck)
            if self.directory is not None:
                self.directory.publish(self.replica_id, cks)
        return adopted

    def _tier_plan(self, prompt: List[int],
                   matched_pages: int) -> Optional[Dict[str, Any]]:
        """A plan covering full prompt pages PAST the radix match from a
        colder source: consecutive demoted frames in the tier store
        first, else the longest prefix a directory sibling claims; None
        when only recompute remains. At least one prompt token stays
        uncovered, as in the radix lookup."""
        if self.tiers is None and self.directory is None:
            return None
        ps = self.page_size
        max_cover = (len(prompt) - 1) // ps
        if matched_pages >= max_cover:
            return None
        cks = chain_keys(prompt[:max_cover * ps], ps)
        if self.tiers is not None:
            cover = matched_pages
            while cover < max_cover and self.tiers.has(cks[cover]):
                cover += 1
            if cover > matched_pages:
                return {"kind": "tier", "base": matched_pages,
                        "chains": cks[matched_pages:cover]}
        if self.directory is not None and self.peer_fetch is not None:
            for j in range(max_cover, matched_pages, -1):
                holder = self.directory.lookup(cks[j - 1],
                                               exclude=self.replica_id)
                if holder is not None:
                    return {"kind": "fleet", "base": matched_pages,
                            "holder": holder, "cover": j}
        return None

    def _tier_tick(self) -> None:
        """Land every pending plan: install the cold bytes into the
        stream's own pages, adopt the covered prefix into the radix, and
        only then queue the stream for prefill. A plan whose frames went
        missing or corrupt (or whose hint went stale) recomputes from the
        radix-matched position: the stream loses the shortcut, never
        tokens."""
        if not self._pending_tier:
            return
        plans, self._pending_tier = self._pending_tier, []
        for plan in plans:
            slot = plan["slot"]
            if self.requests[slot] is not plan["req"]:
                continue                       # aborted while deferred
            t0 = time.perf_counter()
            if plan["kind"] == "tier":
                if not self._promote_from_tier(plan):
                    self.tier_fallbacks += 1
            elif not self._adopt_from_fleet(plan):
                self.directory_fallbacks += 1
            self.tier_promote_s += time.perf_counter() - t0
            self._prefill_q.append(slot)

    @staticmethod
    def _concat_pages(sides: List[Any]):
        """Stack per-page payloads ``[L, 1, page, KV, D]`` into one span
        payload along the page axis (a ``{"q", "s"}`` dict for int8)."""
        if isinstance(sides[0], dict):
            return {"q": torch.cat([s["q"] for s in sides], dim=1),
                    "s": torch.cat([s["s"] for s in sides], dim=1)}
        return torch.cat(sides, dim=1)

    def _span_fits(self, payload: Dict[str, Any], pages: int) -> bool:
        want = (self.cfg.n_layers, pages, self.page_size,
                self.cfg.n_kv_heads, self.cfg.head_dim)
        return all(_payload_shape(payload[side]) == want
                   for side in ("k", "v"))

    def _install(self, payload: Dict[str, Any], a: int, b: int,
                 phys: List[int]) -> None:
        """Install payload pages ``[a:b)`` into pool pages ``phys``."""
        idx = torch.tensor(phys, dtype=torch.long, device=self.device)
        for side in ("k", "v"):
            _install_pages(self.pool[side],
                           _payload_slice(payload[side], a, b,
                                          self.pool[side]), idx)

    def _promote_from_tier(self, plan: Dict[str, Any]) -> bool:
        """Install the longest verified run of demoted frames for the
        plan's chains. ``take`` POPS each frame, so this promote is the
        content's single owner the instant it holds the bytes."""
        slot = plan["slot"]
        prompt = self._prompts[slot]
        ps = self.page_size
        entries = []
        for ck in plan["chains"]:
            e = self.tiers.take(ck)
            if (e is None
                    or bool(e.get("kv_quant")) != bool(self.cfg.kv_quant)):
                break                          # missing/corrupt: stop run
            entries.append(e)
        if not entries:
            return False
        m = len(entries)
        base = plan["base"]
        payload = {side: self._concat_pages([e["payload"][side]
                                             for e in entries])
                   for side in ("k", "v")}
        if not self._span_fits(payload, m):
            return False                       # foreign geometry: recompute
        self._install(payload, 0, m,
                      self._stream_pages[slot][base:base + m])
        self._prefill_pos[slot] = (base + m) * ps
        self.tier_promoted_pages += m
        self._radix_adopt(prompt[:(base + m) * ps],
                          self._stream_pages[slot][:base + m])
        return True

    def _adopt_from_fleet(self, plan: Dict[str, Any]) -> bool:
        """Fetch the hinted sibling's prefix (digest-verified on the
        wire) and install it like a tier promote. Any failure (the
        holder died, evicted the prefix, or shipped something that does
        not fit) is a recompute fallback, never an error."""
        slot = plan["slot"]
        prompt = self._prompts[slot]
        ps = self.page_size
        try:
            span = self.peer_fetch(plan["holder"],
                                   prompt[:plan["cover"] * ps])
        except Exception:
            span = None
        if span is None:
            return False
        got = list(span.get("prompt", []))
        if (int(span.get("page_size", ps)) != ps
                or bool(span.get("kv_quant")) != bool(self.cfg.kv_quant)
                or len(got) % ps
                or got != prompt[:len(got)]):
            return False
        cover = min(plan["cover"], len(got) // ps)
        base = plan["base"]
        if cover <= base or not self._span_fits(span["payload"],
                                                len(got) // ps):
            return False
        self._install(span["payload"], base, cover,
                      self._stream_pages[slot][base:cover])
        self._prefill_pos[slot] = cover * ps
        self.directory_hits += 1
        self.adopted_prefix_pages += cover - base
        self._radix_adopt(prompt[:cover * ps],
                          self._stream_pages[slot][:cover])
        return True

    def _gather_span(self, pages: List[int]) -> Dict[str, Any]:
        """The pages ``pages`` on the host in logical order, ``[L, N,
        page, KV, D]`` per side (q + scales for int8 pools) as CPU
        tensors: one device-to-host copy per array, on the engine's
        stream, so it reads after every write in flight to them."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)

        def take(side):
            if isinstance(side, QTensor):
                return {"q": side.q.index_select(1, idx).cpu(),
                        "s": side.s.index_select(1, idx).cpu()}
            return side.index_select(1, idx).cpu()

        return {"k": take(self.pool["k"]), "v": take(self.pool["v"])}

    def export_prefix(self, prompt: List[int]) -> Optional[Dict[str, Any]]:
        """Serve a sibling's prefix-adoption fetch: the longest
        radix-cached full-page chain of ``prompt`` as a span on the host
        (``first_token`` is the ``-1`` prefix-span sentinel), gathered
        with the lookup's references held so no eviction frees the pages
        mid-read. None when nothing is cached."""
        if self.radix is None:
            return None
        prompt = list(prompt)
        # lookup covers a PROPER prefix only; one sentinel token lets a
        # prompt of exactly k full pages match all k
        shared, _ = self.radix.lookup(prompt + [-1])
        if not shared:
            return None
        try:
            payload = self._gather_span(shared)
        finally:
            for p in shared:
                self.ledger.unref(p)
        self.exported_prefixes += 1
        return {"version": 1,
                "prompt": prompt[:len(shared) * self.page_size],
                "first_token": -1, "page_size": self.page_size,
                "kv_quant": bool(self.cfg.kv_quant), "payload": payload}

    def _admit(self, prompt: List[int], max_new: int,
               request_id: Any) -> Optional[int]:
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        n = len(prompt)
        ps = self.page_size
        total = -(-(n + max_new) // ps)
        shared: List[int] = []
        node = None
        if self.radix is not None:
            shared, node = self.radix.lookup(prompt)
        plan = (self._tier_plan(prompt, len(shared))
                if self.radix is not None else None)
        own_needed = total - len(shared)
        pages = self.ledger.alloc(own_needed)
        if pages is None and self.radix is not None:
            # under pressure the radix gives back LRU unshared pages
            self._evict(own_needed - self.ledger.free_count())
            pages = self.ledger.alloc(own_needed)
        if pages is None:
            for p in shared:                   # undo the lookup refs
                self.ledger.unref(p)
            return None
        matched = len(shared) * ps
        start = matched
        if node is not None and plan is None:
            b = self.radix.boundary(node, prompt, matched)
            if b is not None:
                src, valid = b
                # eager COW: the cached page's first `valid` rows are
                # our positions' K/V; copy it into our first private page
                # and prefill only past them
                for side in ("k", "v"):
                    _copy_page(self.pool[side], src, pages[0])
                start = matched + valid
        stream_pages = shared + pages
        row = self._tables[slot]
        row[:] = self.scratch
        row[:total] = stream_pages
        self._stream_pages[slot] = stream_pages
        self._prompts[slot] = prompt
        self._prefill_pos[slot] = start
        self._decoding[slot] = False
        rid = request_id if request_id is not None else object()
        self.requests[slot] = _Request(rid, n, max_new, [])
        if plan is not None:
            # the stream defers ONE step: it joins the prefill queue when
            # _tier_tick lands or abandons the plan
            plan["slot"] = slot
            plan["req"] = self.requests[slot]
            self._pending_tier.append(plan)
        else:
            self._prefill_q.append(slot)
        return slot

    # ----------------------------------------------------- disaggregation

    def prefill_span(self, prompt: List[int],
                     trace=None) -> Optional[Dict[str, Any]]:
        """The prefill tier's whole job: run ``prompt`` through chunked
        prefill flat out (every chunk back to back, no decode, no slot
        occupied) and return the finished span: the prompt's K/V pages on
        the host (:meth:`_gather_span`) and the first generated token. The
        span's full prompt pages enter this engine's radix before its
        working references drop, so a repeated system prompt skips the
        compute next time. None when the pool is exhausted (transient);
        ValueError for a prompt this engine can never prefill. ``trace``
        (an incoming ``tracing.TraceContext``) gets one
        ``engine.prefill_span`` span."""
        _refuse_mesh(self, "prefill_span")
        t_pre0 = time.perf_counter()
        prompt = list(prompt)
        n = len(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if n + 1 > self.cfg.max_seq:
            # the decode side must have room for >= 1 generated token
            raise ValueError(f"prompt {n} leaves no decode room in "
                             f"max_seq {self.cfg.max_seq}")
        ps = self.page_size
        span_pages = -(-n // ps)
        if span_pages > self.total_pages:
            raise ValueError(f"prompt {n} needs {span_pages} pages but "
                             f"the pool holds {self.total_pages}")
        shared: List[int] = []
        node = None
        if self.radix is not None:
            shared, node = self.radix.lookup(prompt)
        own_needed = span_pages - len(shared)
        pages = self.ledger.alloc(own_needed)
        if pages is None and self.radix is not None:
            self._evict(own_needed - self.ledger.free_count())
            pages = self.ledger.alloc(own_needed)
        if pages is None:
            for p in shared:
                self.ledger.unref(p)
            return None
        matched = len(shared) * ps
        start = matched
        if node is not None:
            b = self.radix.boundary(node, prompt, matched)
            if b is not None:
                src, valid = b
                for side in ("k", "v"):
                    _copy_page(self.pool[side], src, pages[0])
                start = matched + valid
        stream_pages = shared + pages
        row = np.full((self.pages_per_stream,), self.scratch, np.int32)
        row[:span_pages] = stream_pages
        tbl = torch.from_numpy(row).to(self.device)
        while start < n:
            logits, start = self._chunk(tbl, prompt, start)
        first = int(self._select(logits)[0])
        payload = self._gather_span(stream_pages)
        if self.radix is not None:
            self._radix_adopt(prompt, stream_pages)
        for p in stream_pages:
            self.ledger.unref(p)
        self.shipped_spans += 1
        tracer = self.tracer
        if tracer is not None and trace is not None:
            tracer.record("engine.prefill_span", t_pre0,
                          time.perf_counter(), parent=trace,
                          prompt_len=n, pages=span_pages,
                          shared_pages=len(shared))
        return {"version": 1, "prompt": prompt, "first_token": first,
                "page_size": ps, "kv_quant": bool(self.cfg.kv_quant),
                "payload": payload}

    def adopt_pages(self, span: Dict[str, Any], max_new: int = 32,
                    request_id: Any = None) -> Optional[int]:
        """Install a foreign prefill span (a peer's :meth:`prefill_span`,
        possibly shipped by ``models.disagg``) under the ledger's
        refcounts and start the stream decode-active at its first token.
        Admission is gated on pages free as in :meth:`submit`: the stream
        index, or None when streams or pages are exhausted. Full prompt
        pages the radix already holds are shared by reference and their
        payload is never written; the rest install IN PLACE into the pool
        (:meth:`_install`), and the length and first token are written
        into the bound ``lengths`` and ``cur_tok``, since captured windows
        read those very tensors. ValueError for a span this engine can
        never admit, raised before any reservation; a failure after the
        reservation gives every reference back before re-raising. As in
        the reference, an armed draft's cache is not prefilled here."""
        _refuse_mesh(self, "adopt_pages")
        t_adopt0 = time.perf_counter()
        prompt = list(span["prompt"])
        n = len(prompt)
        first = int(span["first_token"])
        if int(span.get("page_size", self.page_size)) != self.page_size:
            raise ValueError(
                f"span page_size {span.get('page_size')} != pool page "
                f"size {self.page_size}; tiers must agree")
        if bool(span.get("kv_quant")) != bool(self.cfg.kv_quant):
            raise ValueError("span/pool kv_quant mismatch: shipped "
                             "pages are raw pool bytes, tiers must "
                             "run the same KV dtype")
        reason = self._validate_item({"prompt": prompt,
                                      "max_new": max_new})
        if reason is not None:
            raise ValueError(reason)
        ps = self.page_size
        span_pages = -(-n // ps)
        payload = span["payload"]
        if not self._span_fits(payload, span_pages):
            want = (self.cfg.n_layers, span_pages, ps, self.cfg.n_kv_heads,
                    self.cfg.head_dim)
            raise ValueError(f"span payload shape "
                             f"{_payload_shape(payload['k'])} != pool page "
                             f"shape {want}")
        self._flush_pending()
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        total = -(-(n + max_new) // ps)
        shared: List[int] = []
        if self.radix is not None:
            shared, _ = self.radix.lookup(prompt)
        own_needed = total - len(shared)
        pages = self.ledger.alloc(own_needed)
        if pages is None and self.radix is not None:
            self._evict(own_needed - self.ledger.free_count())
            pages = self.ledger.alloc(own_needed)
        if pages is None:
            for p in shared:
                self.ledger.unref(p)
            return None
        matched = len(shared)
        try:
            # the shipped K/V for prompt pages past the radix match; the
            # decode-tail pages start blank, as any stream's
            install = span_pages - matched
            if install > 0:
                self._install(payload, matched, span_pages,
                              pages[:install])
        except Exception:
            # an aborted transfer: every reservation unwinds
            for p in shared:
                self.ledger.unref(p)
            for p in pages:
                self.ledger.unref(p)
            raise
        stream_pages = shared + pages
        row = self._tables[slot]
        row[:] = self.scratch
        row[:total] = stream_pages
        self._stream_pages[slot] = stream_pages
        self._prompts[slot] = prompt
        self._prefill_pos[slot] = n
        self._decoding[slot] = True
        self.lengths[slot] = n
        self.cur_tok[slot] = first
        rid = request_id if request_id is not None else object()
        self.requests[slot] = _Request(rid, n, max_new, [first])
        self.adopted_spans += 1
        self.adopt_shared_pages += matched
        tracer = self.tracer
        if tracer is not None:
            ctx = getattr(rid, "trace", None)
            if ctx is not None:
                tracer.record("engine.adopt_span", t_adopt0,
                              time.perf_counter(), parent=ctx,
                              pages=span_pages, shared_pages=matched)
        self._maybe_retire(slot)
        return slot

    # ----------------------------------------------------- live migration

    def export_stream(self, slot: int) -> Optional[Dict[str, Any]]:
        """Freeze the decode stream in ``slot`` at a window boundary and
        return its portable state: the K/V pages of every position written
        so far (:meth:`_gather_span`, ordered after every write in
        flight) and what a destination needs to resume token-exact: the
        prompt, every generated token, the budget and the generator's
        state (None on a greedy engine). A pure READ: the victim keeps its
        pages and bookkeeping and keeps decoding until
        :meth:`release_stream`, so a failed migration leaves the stream
        untouched. None for an empty slot or a stream still prefilling
        (the caller re-submits its prompt instead).

        The pool holds ``prompt_len + len(tokens) - 1`` written positions
        (the last token's K/V is written by the destination's next decode
        step, as it would be here), so that, not the reserved span, is
        what ships; the last page may be partial."""
        _refuse_mesh(self, "export_stream")
        self._flush_pending()           # a window boundary, never mid-flush
        if not (0 <= slot < self.slots):
            return None
        r = self.requests[slot]
        if r is None or not self._decoding[slot] or not r.tokens:
            return None
        n = r.prompt_len
        ps = self.page_size
        kv_len = n + len(r.tokens) - 1
        pages = self._stream_pages[slot][:-(-kv_len // ps)]
        rng = (self.generator.get_state().numpy()
               if self.generator is not None else None)
        return {"version": 1, "prompt": list(self._prompts[slot]),
                "tokens": list(r.tokens), "max_new": int(r.budget),
                "page_size": ps, "kv_quant": bool(self.cfg.kv_quant),
                "rng_key": rng, "payload": self._gather_span(pages)}

    def _rng_state(self, rng: Any) -> torch.Tensor:
        """The shipped RNG state as this engine's generator takes it: a
        uint8 array the size of its own state, else ValueError (a JAX key,
        or a CPU generator's state on a CUDA engine)."""
        if self.generator is None:
            raise ValueError("adopt_rng: this engine samples nothing (no "
                             "generator to restore the state into)")
        own = self.generator.get_state()
        arr = np.asarray(rng.cpu() if isinstance(rng, torch.Tensor)
                         else rng)
        if arr.dtype != np.uint8 or arr.shape != tuple(own.shape):
            raise ValueError(
                f"adopt_rng: shipped rng_key {arr.dtype.name}"
                f"{list(arr.shape)} is not this engine's generator state "
                f"(uint8{list(own.shape)})")
        return torch.from_numpy(np.array(arr))

    def import_stream(self, state: Dict[str, Any], request_id: Any = None,
                      adopt_rng: bool = False) -> Optional[int]:
        """Adopt a migrated decode stream (a victim's
        :meth:`export_stream`, possibly shipped as a DECSTATE frame by
        ``models.migrate``) and resume it mid-stream: it joins the decode
        batch at position ``prompt + generated - 1`` with its tokens,
        budget and identity, so a greedy continuation is token-exact.

        The transaction is :meth:`adopt_pages`'s: config, shape and RNG
        mismatches raise ValueError BEFORE any reservation; no free slot
        or pages returns None; a failure after the reservation gives every
        reference back before re-raising. Full prompt pages the radix
        holds are shared; the rest install IN PLACE (:meth:`_install`),
        and the length and last token are written into the bound
        ``lengths`` and ``cur_tok``. ``adopt_rng`` sets the engine's own
        generator to the shipped state (engine-global, so only sensible
        when the destination carries no other sampled stream)."""
        _refuse_mesh(self, "import_stream")
        t_mig0 = time.perf_counter()
        prompt = list(state["prompt"])
        tokens = [int(t) for t in state["tokens"]]
        n = len(prompt)
        max_new = int(state["max_new"])
        if not tokens:
            raise ValueError("decode state carries no generated tokens; "
                             "ship a prefill span instead")
        if int(state.get("page_size", self.page_size)) != self.page_size:
            raise ValueError(
                f"stream page_size {state.get('page_size')} != pool page "
                f"size {self.page_size}; tiers must agree")
        if bool(state.get("kv_quant")) != bool(self.cfg.kv_quant):
            raise ValueError("stream/pool kv_quant mismatch: shipped "
                             "pages are raw pool bytes, tiers must run "
                             "the same KV dtype")
        reason = self._validate_item({"prompt": prompt,
                                      "max_new": max_new})
        if reason is not None:
            raise ValueError(reason)
        if len(tokens) >= max_new or n + len(tokens) >= self.cfg.max_seq:
            raise ValueError("stream already complete; nothing to "
                             "resume: deliver its tokens instead")
        ps = self.page_size
        kv_len = n + len(tokens) - 1
        span_pages = -(-kv_len // ps)
        payload = state["payload"]
        if not self._span_fits(payload, span_pages):
            want = (self.cfg.n_layers, span_pages, ps, self.cfg.n_kv_heads,
                    self.cfg.head_dim)
            raise ValueError(f"stream payload shape "
                             f"{_payload_shape(payload['k'])} != pool page "
                             f"shape {want}")
        rng = None
        if adopt_rng and state.get("rng_key") is not None:
            rng = self._rng_state(state["rng_key"])
        self._flush_pending()
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        total = -(-(n + max_new) // ps)
        shared: List[int] = []
        if self.radix is not None:
            # full PROMPT pages dedupe as at adoption: the shipped span
            # covers every shared page (kv_len >= n)
            shared, _ = self.radix.lookup(prompt)
        own_needed = total - len(shared)
        pages = self.ledger.alloc(own_needed)
        if pages is None and self.radix is not None:
            self._evict(own_needed - self.ledger.free_count())
            pages = self.ledger.alloc(own_needed)
        if pages is None:
            for p in shared:
                self.ledger.unref(p)
            return None
        matched = len(shared)
        try:
            install = span_pages - matched
            if install > 0:
                self._install(payload, matched, span_pages,
                              pages[:install])
        except Exception:
            # an aborted install: every reservation unwinds, and the
            # victim, which still holds the stream, resumes untouched
            for p in shared:
                self.ledger.unref(p)
            for p in pages:
                self.ledger.unref(p)
            raise
        stream_pages = shared + pages
        row = self._tables[slot]
        row[:] = self.scratch
        row[:total] = stream_pages
        self._stream_pages[slot] = stream_pages
        self._prompts[slot] = prompt
        self._prefill_pos[slot] = n
        self._decoding[slot] = True
        self.lengths[slot] = kv_len
        self.cur_tok[slot] = tokens[-1]
        rid = request_id if request_id is not None else object()
        self.requests[slot] = _Request(rid, n, max_new, list(tokens))
        if rng is not None:
            self.generator.set_state(rng)
        self.migrated_in += 1
        tracer = self.tracer
        if tracer is not None:
            ctx = getattr(rid, "trace", None)
            if ctx is not None:
                tracer.record("engine.import_stream", t_mig0,
                              time.perf_counter(), parent=ctx,
                              pages=span_pages, shared_pages=matched,
                              generated=len(tokens))
        self._maybe_retire(slot)
        return slot

    def release_stream(self, slot: int) -> bool:
        """Confirm a migration: drop the victim's copy of the stream
        WITHOUT recording a result (the destination owns it now). Every
        page unrefs through :meth:`_release`, and a stream that finished
        prefilling adopts its full prompt pages into the radix first, as
        at retirement. A stream still prefilling also leaves the prefill
        queue. Call only after the adoption committed."""
        if not (0 <= slot < self.slots) or self.requests[slot] is None:
            return False
        decoded = self._decoding[slot]
        self.requests[slot] = None
        self._pending_first.pop(slot, None)
        if slot in self._prefill_q:
            self._prefill_q.remove(slot)
        self._release(slot, adopt=decoded)
        self.migrated_out += 1
        return True

    # ------------------------------------------------------------- decode

    def _flush_pending(self) -> None:
        """Bring every deferred first token to the host in ONE transfer,
        append it, and turn its stream decode-active. Called at the top
        of every engine entry point that may observe request state."""
        if not self._pending_first:
            return
        items = sorted(self._pending_first.items())
        self._pending_first.clear()
        vals = torch.stack([t for _, t in items]).tolist()
        for (slot, _), tok in zip(items, vals):
            r = self.requests[slot]
            if r is None:
                continue                       # aborted before flush
            r.tokens.append(int(tok))
            self._decoding[slot] = True
            self._maybe_retire(slot)

    def _chunk(self, tbl: torch.Tensor, prompt: List[int],
               start: int) -> Tuple[torch.Tensor, int]:
        """One fixed-shape prefill chunk of ``prompt`` from ``start``
        through the page-table row ``tbl``: (logits at the prompt's last
        position when the chunk reaches it, the chunk's end)."""
        n = len(prompt)
        c = self.prefill_chunk
        end = min(start + c, n)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :end - start] = prompt[start:end]
        li = (n - 1 - start) if end >= n else 0
        logits, self.pool = llama.prefill_chunk_paged(
            self.cfg, self.params, self.pool, tbl,
            torch.from_numpy(chunk).to(self.device), start, n, li,
            self.scratch, rope=self._rope, ffn_override=self._ffn,
            mesh=self.mesh)
        return logits, end

    def _ring_prefill(self, slot: int) -> bool:
        """Prefill the WHOLE prompt of ``slot`` in one sequence-parallel
        tick (:func:`llama.prefill_ring` over the mesh's ``sp`` axis).
        Returns True when the stream is decode-ready; False, counting a
        ``longctx_fallback``, when its padded length is over ``max_seq``:
        the one disqualification, a pure function of the broadcast
        intake, so every rank falls back alike and the caller prefills in
        chunks.

        Every rank's K/V shard is gathered over sp in rank order, and the
        whole span lands page by page in the local pool, in place (the
        captured windows bind the pool tensors); pad pages go to the
        scratch page. The last prompt position lives on one rank: its
        logits are summed over sp with zeros from the others, which
        hands every rank the same fp32 bits, so ``_select`` (and a
        sampler's generator) advances alike on every rank. Unlike the
        reference, nothing from the first collective on is caught: a
        rank that fell back while its peers ring would hang the gang, so
        a failure raises :class:`RingPrefillError` and fails the
        replica. Only runs from position 0: a radix-resumed stream's
        leading pages are shared, and the ring writes the whole span."""
        prompt = self._prompts[slot]
        n = len(prompt)
        ps, sp = self.page_size, self._ring_sp
        s_pad = ring_pad_len(n, sp, ps)
        # the reference's intake guard: unreachable while the constructor
        # makes sp and the page size divide max_seq (a test stubs it)
        if s_pad > self.cfg.max_seq:
            self.longctx_fallbacks += 1
            return False
        n_pages = s_pad // ps
        own = -(-n // ps)              # pages that hold prompt positions
        phys = np.full((n_pages,), self.scratch, np.int64)
        phys[:own] = self._tables[slot][:own]
        padded = np.zeros((1, s_pad), np.int32)
        padded[0, :n] = prompt
        cfg, mesh, dev = self.cfg, self.mesh, self.device
        t0 = time.perf_counter()
        try:
            hidden, ks, vs = llama.prefill_ring(
                cfg, self.params, torch.from_numpy(padded).to(dev), mesh,
                rope=self._rope, ffn_override=self._ffn)
            kv = mesh.all_gather(torch.stack([ks, vs])[:, :, 0], "sp",
                                 dim=2)          # [2, L, s_pad, KV, D]
            kv = kv.reshape(2, cfg.n_layers, n_pages, ps, *kv.shape[3:])
            where = torch.from_numpy(phys).to(dev)
            _install_pages(self.pool["k"], kv[0], where)
            _install_pages(self.pool["v"], kv[1], where)
            del kv, ks, vs
            shard = s_pad // sp
            logits = torch.zeros((1, cfg.vocab_size), dtype=torch.float32,
                                 device=dev)
            if (n - 1) // shard == mesh.coords["sp"]:
                logits = llama._lm_head(hidden[:, (n - 1) % shard],
                                        self.params, None)
            logits = mesh.all_reduce(logits, "sp")
        except Exception as e:
            raise RingPrefillError(
                f"ring prefill of a {n}-token prompt over sp={sp} failed "
                f"after its first collective: {e!r}") from e
        toks = self._select(logits)
        self.lengths[slot] = n
        self.cur_tok[slot] = toks[0]
        self._pending_first[slot] = toks[0]
        self._prefill_pos[slot] = n
        self.ring_prefills += 1
        self.ring_prefilled_tokens += n
        self.ring_prefill_s += time.perf_counter() - t0
        return True

    def _prefill_tick(self) -> None:
        """Run ONE fixed-shape prefill chunk for the stream at the head
        of the prefill queue. With ``longctx_ring`` armed, a prompt of at
        least ``ring_threshold`` tokens starting from position 0
        prefills WHOLE in one sequence-parallel tick instead
        (:meth:`_ring_prefill`), or falls back to chunks."""
        while self._prefill_q and self.requests[self._prefill_q[0]] is None:
            self._prefill_q.popleft()          # aborted mid-prefill
        if not self._prefill_q:
            return
        slot = self._prefill_q[0]
        prompt = self._prompts[slot]
        n = len(prompt)
        if (self._ring_sp > 1 and self._prefill_pos[slot] == 0
                and n >= self.ring_threshold and self._ring_prefill(slot)):
            self._prefill_q.popleft()
            return
        logits, end = self._chunk(
            torch.tensor(self._tables[slot], device=self.device), prompt,
            self._prefill_pos[slot])
        self._prefill_pos[slot] = end
        if end >= n:
            toks = self._select(logits)
            self.lengths[slot] = n
            self.cur_tok[slot] = toks[0]
            # the first token stays on the device; the stream turns
            # decode-active at the NEXT flush, never in this call:
            # otherwise decode would append tokens before the first one
            # lands, and an EOS/budget-1 first token would decode steps
            self._pending_first[slot] = toks[0]
            self._prefill_q.popleft()
            if self._draft is not None:
                # the draft sees the WHOLE prompt, pages the radix
                # adopted for the target included
                self._draft_prefill(slot, prompt)

    def _decode_tables(self) -> np.ndarray:
        """Tables for the decode step: any stream not actively decoding
        (idle, still prefilling, retired) points at the scratch page."""
        mask = np.array(
            [self._decoding[i] and self.requests[i] is not None
             for i in range(self.slots)])
        return np.where(mask[:, None], self._tables,
                        np.int32(self.scratch))

    def _window_mp(self, active: List[int], k: int) -> int:
        """Leading table columns a ``k``-step decode window can touch:
        the host mirror of a stream's device length is ``prompt_len +
        len(tokens) - 1``, so the highest position written or read this
        window is that + ``k``. Frozen rows may carry lengths past the
        truncated span; their clipped writes land on scratch."""
        top = max(self.requests[i].prompt_len
                  + len(self.requests[i].tokens) for i in active)
        return min(self.pages_per_stream,
                   (top + k - 2) // self.page_size + 1)

    def _active(self) -> List[int]:
        return [i for i in range(self.slots)
                if self.requests[i] is not None and self._decoding[i]]

    def step(self) -> Dict[int, int]:
        """One prefill chunk (if queued) + one decode step for every
        decode-active stream; returns {stream: token}."""
        return {slot: toks[0] for slot, toks in self._decode(1).items()}

    def step_many(self, k: int) -> Dict[int, List[int]]:
        """Up to ``k`` prefill chunks, then a ``k``-step decode window
        with a fixed page table (safe: admission reserved every stream's
        full span). Returns {stream: [tokens...]}, each list cut at the
        stream's retirement. Streams retiring mid-window keep decoding
        dead steps, as in the reference's fixed-mask scan. With a draft
        armed, one speculative window instead (:meth:`_spec_step_many`)."""
        if self._draft is not None:
            return self._spec_step_many(max(k, 1))
        return self._decode(max(k, 1))

    def _table(self, mp: int) -> torch.Tensor:
        """The static decode table of a window of width ``mp``: [slots,
        mp], contiguous, a view of the flat buffer."""
        return self._table_buf[:self.slots * mp].view(self.slots, mp)

    def _step_logits(self, lengths: torch.Tensor, tokens: torch.Tensor,
                     mp: Optional[int]) -> torch.Tensor:
        logits, _ = llama.decode_step_paged(
            self.cfg, self.params, self.pool, self._table(mp), lengths,
            tokens, rope=self._rope, ffn_override=self._ffn, mesh=self.mesh)
        return logits

    def _decode(self, k: int) -> Dict[int, List[int]]:
        self._flush_pending()
        self._tier_tick()
        for _ in range(k):
            self._prefill_tick()
            if not self._prefill_q:
                break
        active = self._active()
        if not active:
            return {}
        mp = self._window_mp(active, k)
        self._table(mp).copy_(torch.from_numpy(
            np.ascontiguousarray(self._decode_tables()[:, :mp])))
        host = self._run_window((k, mp), active,
                                lambda: self._window(k, mp))
        return self._emit(host, active)

    def warmup(self, widths=(1,), window: int = 1) -> Dict[str, float]:
        """The cold-start ``compile`` phase before admission: one prefill
        chunk, then the ``window``-step decode window (one step by
        default) of each decode-table width in ``widths`` captured as a
        CUDA graph (on CUDA) and run once, every write landing on the
        scratch page and no length or token advancing. Windows of other
        sizes or widths are captured at first use (under tp > 1 the
        windows run eagerly, and so does the warm-up). Returns ``{phase:
        seconds}`` with the reference's keys (``chunk``, ``step_w<w>``;
        ``step<k>_w<w>`` for a window of k > 1 steps)."""
        widths = [int(w) for w in widths]
        for w in widths:
            if not 1 <= w <= self.pages_per_stream:
                raise ValueError(f"warmup width {w} outside [1, "
                                 f"{self.pages_per_stream}]")
        timings: Dict[str, float] = {}
        dev = self.device
        self._tier_tick()      # no plan may be pending across a capture
        t0 = time.perf_counter()
        row = torch.full((self.pages_per_stream,), self.scratch,
                         dtype=torch.int32, device=dev)
        c = self.prefill_chunk
        logits, self.pool = llama.prefill_chunk_paged(
            self.cfg, self.params, self.pool, row,
            torch.zeros((1, c), dtype=torch.int32, device=dev), 0, c, c - 1,
            self.scratch, rope=self._rope, ffn_override=self._ffn,
            mesh=self.mesh)
        logits.cpu()
        timings["chunk"] = time.perf_counter() - t0
        k = max(int(window), 1)
        for w in widths:
            t1 = time.perf_counter()
            self._table(w).fill_(self.scratch)
            self._run_window((k, w), [], lambda: self._window(k, w))
            timings[f"step{k if k > 1 else ''}_w{w}"] = (time.perf_counter()
                                                         - t1)
        return timings

    # ----------------------------------------------- speculative decoding

    def arm_draft(self, cfg_d: llama.LlamaConfig, params_d, k: int = 4,
                  metrics=None) -> None:
        """Arm the speculative path: each ``step_many`` runs ONE window
        of ``k`` draft steps, the K-wide paged verify and the acceptance,
        advancing every stream by ``1 + accepted`` target-verified tokens
        a target pass (the greedy stream, whatever the draft proposes).

        Compatibility is checked here, before a stream uses the draft
        (:class:`~dcos_commons_tpu_torch.models.speculative.
        DraftIncompatible` with the reference's codes), and the widest
        window runs once with every stream masked off (on CUDA
        capturing its graph), so a draft that cannot run fails at arm
        time. Greedy engines only. The draft's cache stays unquantized
        whatever the pool does, and its execution policy follows the
        engine's. ``params_d`` must live on the engine's device."""
        _refuse_mesh(self, "arm_draft")
        from .speculative import DraftIncompatible
        if self.sampler is not None:
            raise DraftIncompatible(
                "draft_sampled_engine",
                "speculative decode is greedy-only; this engine samples")
        if self._ffn is not None:
            raise DraftIncompatible(
                "draft_moe_engine",
                "speculative decode is not supported on MoE engines: the "
                "K-wide verify pass routes a k-token group while the "
                "accepted history was routed one token at a time, so "
                "verify logits would not match the committed path")
        if k < 2:
            raise DraftIncompatible("draft_k", f"draft k must be >= 2, "
                                               f"got {k}")
        if cfg_d.vocab_size != self.cfg.vocab_size:
            raise DraftIncompatible(
                "draft_vocab_mismatch",
                f"draft vocab {cfg_d.vocab_size} != target "
                f"{self.cfg.vocab_size}")
        if cfg_d.rope_theta != self.cfg.rope_theta:
            raise DraftIncompatible(
                "draft_rope_mismatch",
                f"draft rope_theta {cfg_d.rope_theta} != target "
                f"{self.cfg.rope_theta}")
        if cfg_d.max_seq < self.cfg.max_seq:
            raise DraftIncompatible(
                "draft_max_seq",
                f"draft max_seq {cfg_d.max_seq} < target "
                f"{self.cfg.max_seq}: the draft cannot cover every "
                "position this engine serves")
        llama.check_params_device(params_d, self.device, "engine")
        cfg_d = dataclasses.replace(
            cfg_d, kv_quant=False, attn_impl=self.cfg.attn_impl,
            decode_attn=self.cfg.decode_attn, remat=False,
            remat_policy=None)
        self.disarm_draft()
        self._draft = (cfg_d, params_d)
        self.draft_k = int(k)
        self.metrics = metrics
        self._draft_rope = rope_frequencies(cfg_d.head_dim, cfg_d.max_seq,
                                            cfg_d.rope_theta,
                                            device=self.device)
        self._draft_cache = llama.init_kv_cache(cfg_d, self.slots,
                                                cfg_d.max_seq,
                                                device=self.device)
        mp = self.pages_per_stream
        self._table(mp).fill_(self.scratch)
        self._run_window(("spec", self.draft_k, mp), [],
                         lambda: self._spec_window(mp))

    def disarm_draft(self) -> None:
        """Back to solo decode: the draft, its cache and its graphs are
        dropped; the counters survive."""
        self._draft = None
        self._draft_cache = None
        self._draft_rope = None
        self.draft_k = 0
        for key in [key for key in self._graphs if key[0] == "spec"]:
            del self._graphs[key]

    def _spec_window(self, mp: int) -> torch.Tensor:
        """One speculative window over the static state: k greedy draft
        steps over the draft cache consuming ``[cur, d_1 .. d_{k-1}]``
        (the k-th proposal is discarded; its step writes d_{k-1}'s K/V),
        then the target's K-wide paged verify of that window, then the
        acceptance: the agreeing prefix by cumulative product, ``n_emit =
        1 + accepted`` for the active streams (0 for the rest), the new
        lengths and tokens copied into ``lengths`` and ``cur_tok``.
        Returns [slots, k + 1]: the target's tokens, then ``n_emit``."""
        cfg_d, params_d = self._draft
        k = self.draft_k
        ln, tok, mask = self.lengths, self.cur_tok, self._mask
        cur, dtoks = tok, []
        for j in range(k):
            lg, _ = llama.decode_step_slots(cfg_d, params_d,
                                            self._draft_cache, ln + j, cur,
                                            rope=self._draft_rope)
            cur = torch.where(mask, torch.argmax(lg, dim=-1).to(
                torch.int32), cur)
            dtoks.append(cur)
        drafted = torch.stack(dtoks[:k - 1], dim=1)              # [B, k-1]
        window = torch.cat([tok[:, None], drafted], dim=1)       # [B, k]
        logits, _ = llama.verify_step_paged(
            self.cfg, self.params, self.pool, self._table(mp), ln, window,
            rope=self._rope)
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)       # [B, k]
        agree = torch.cumprod((drafted == tgt[:, :k - 1]).to(torch.int32),
                              dim=1)
        n_emit = torch.where(mask, agree.sum(dim=1).to(torch.int32) + 1,
                             torch.zeros_like(ln))
        new_cur = torch.gather(
            tgt, 1, (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
        new_cur = torch.where(mask, new_cur, tok)
        new_ln = ln + n_emit
        out = torch.cat([tgt, n_emit[:, None]], dim=1)
        self.lengths.copy_(new_ln)
        self.cur_tok.copy_(new_cur)
        return out

    def _draft_prefill(self, slot: int, prompt: List[int]) -> None:
        """Write the draft's K/V for a freshly prefilled stream: one
        whole-prompt forward, padded to a multiple of ``prefill_chunk``
        (padded rows are causally downstream of the live ones, never read
        unmasked, and rewritten by decode before they become readable)."""
        cfg_d, params_d = self._draft
        n = len(prompt)
        c = self.prefill_chunk
        padded = -(-n // c) * c
        buf = np.zeros((1, padded), np.int32)
        buf[0, :n] = prompt
        t0 = time.perf_counter()
        _, ks, vs = llama.prefill_trunk(
            cfg_d, params_d, torch.from_numpy(buf).to(self.device),
            self._draft_rope)
        rows = torch.tensor([slot], device=self.device)
        _scatter_rows(self._draft_cache["k"], ks, rows)
        _scatter_rows(self._draft_cache["v"], vs, rows)
        dt = time.perf_counter() - t0
        self.spec_draft_prefill_s += dt
        if self.metrics is not None:
            self.metrics.observe("serving.spec.draft_prefill_seconds", dt)

    def _spec_step_many(self, k: int) -> Dict[int, List[int]]:
        """The armed dispatch: up to ``k`` prefill chunks (the solo
        window's pacing), then ONE speculative window of ``draft_k``
        advancing every active stream by ``1 + accepted`` tokens,
        committed per stream until its retirement. The verify writes only
        through tables allocated at admission, so the page ledger never
        hears of a window. A failed window disarms the draft before
        re-raising: the caller's reset and retry then run solo."""
        self._flush_pending()
        self._tier_tick()
        for _ in range(k):
            self._prefill_tick()
            if not self._prefill_q:
                break
        active = self._active()
        if not active:
            return {}
        kd = self.draft_k
        mp = self._window_mp(active, kd)
        self._table(mp).copy_(torch.from_numpy(
            np.ascontiguousarray(self._decode_tables()[:, :mp])))
        t0 = time.perf_counter()
        try:
            host = self._run_window(("spec", kd, mp), active,
                                    lambda: self._spec_window(mp))
        except Exception:
            self.spec_fallbacks += 1
            if self.metrics is not None:
                self.metrics.counter("serving.spec.fallbacks")
            self.disarm_draft()
            raise
        dt = time.perf_counter() - t0
        self.spec_windows += 1
        self.spec_window_s += dt
        out: Dict[int, List[int]] = {}
        accepted = 0
        for i in active:
            n = int(host[i, kd])
            self.spec_proposed += kd - 1
            self.spec_accepted += n - 1
            accepted += n - 1
            emitted: List[int] = []
            for t in host[i, :n]:
                emitted.append(int(t))
                self.requests[i].tokens.append(int(t))
                self._maybe_retire(i)
                if self.requests[i] is None:
                    break
            out[i] = emitted
        if self.metrics is not None:
            self.metrics.counter("serving.spec.windows")
            self.metrics.counter("serving.spec.proposed",
                                 float(len(active) * (kd - 1)))
            self.metrics.counter("serving.spec.accepted", float(accepted))
            self.metrics.observe("serving.spec.window_seconds", dt)
        return out

    # --------------------------------------------------------- retirement

    def _maybe_retire(self, slot: int) -> None:
        r = self.requests[slot]
        if r is None or not r.tokens:
            return
        done = (len(r.tokens) >= r.budget
                or (self.eos_id is not None
                    and r.tokens[-1] == self.eos_id)
                or r.prompt_len + len(r.tokens) >= self.cfg.max_seq)
        if done:
            self.finished[r.request_id] = r.tokens
            self.requests[slot] = None
            self._release(slot, adopt=True)

    def _release(self, slot: int, adopt: bool) -> None:
        """Give a stream's pages back: optionally adopt its full prompt
        pages into the radix (adoption takes its own references BEFORE
        the stream's drop), then drop the stream's reference on every
        page and point the table row at scratch."""
        pages = self._stream_pages[slot]
        prompt = self._prompts[slot]
        if adopt and self.radix is not None and prompt is not None:
            # full prompt pages hold prompt-determined K/V only; a
            # mid-window garbage write can only land in the final
            # allocated page, which is never a full prompt page
            self._radix_adopt(prompt, pages)
        for p in pages:
            self.ledger.unref(p)
        self._stream_pages[slot] = []
        self._prompts[slot] = None
        self._prefill_pos[slot] = 0
        self._decoding[slot] = False
        self._tables[slot, :] = self.scratch

    def abort_active(self) -> int:
        """Drop every in-flight request and return EVERY page it held
        (mid-prefill pages may hold partial garbage, so nothing is
        adopted into the radix); returns how many were dropped."""
        dropped = 0
        for i, r in enumerate(self.requests):
            if r is not None:
                self.requests[i] = None
                self._release(i, adopt=False)
                dropped += 1
        self._prefill_q.clear()
        self._pending_first.clear()
        return dropped

    # -------------------------------------------------------------- audit

    def expected_refs(self) -> Dict[int, int]:
        """page -> references actually held (live stream tables + the
        radix): the invariant checker's cross-check input."""
        expected: Dict[int, int] = {}
        for pages in self._stream_pages:
            for p in pages:
                expected[p] = expected.get(p, 0) + 1
        if self.radix is not None:
            for p, cnt in self.radix.held().items():
                expected[p] = expected.get(p, 0) + cnt
        return expected

    def ledger_violations(self) -> List[str]:
        """Empty when the page ledger is healthy."""
        return self.ledger.check(self.expected_refs())

    def page_stats(self) -> Dict[str, Any]:
        return {
            "pages": self.total_pages,
            "page_size": self.page_size,
            "pages_free": self.ledger.free_count(),
            "pages_in_use": self.ledger.in_use(),
            "pages_in_use_peak": self.ledger.in_use_peak,
            "prefix_hits": self.radix.hits if self.radix else 0,
            "prefix_shared_pages": (self.radix.shared_pages
                                    if self.radix else 0),
            "shipped_spans": self.shipped_spans,
            "adopted_spans": self.adopted_spans,
            "adopt_shared_pages": self.adopt_shared_pages,
            "migrated_out": self.migrated_out,
            "migrated_in": self.migrated_in,
            "tier_demoted_pages": self.tier_demoted_pages,
            "tier_promoted_pages": self.tier_promoted_pages,
            "tier_fallbacks": self.tier_fallbacks,
            "tier_promote_s": self.tier_promote_s,
            "directory_hits": self.directory_hits,
            "directory_fallbacks": self.directory_fallbacks,
            "adopted_prefix_pages": self.adopted_prefix_pages,
            "exported_prefixes": self.exported_prefixes,
            "tiers": self.tiers.stats() if self.tiers is not None else None,
            "directory": (self.directory.stats()
                          if self.directory is not None else None),
            "spec": {
                "armed": self._draft is not None,
                "k": self.draft_k,
                "windows": self.spec_windows,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
                "fallbacks": self.spec_fallbacks,
                "draft_prefill_s": self.spec_draft_prefill_s,
                "window_s": self.spec_window_s,
            },
            "moe": ({
                "experts": self.moe.num_experts,
                "capacity_factor": self.moe.capacity_factor,
                "routing": self.moe.routing,
            } if self.moe is not None else None),
            "longctx": {
                "ring": self._ring_sp,
                "threshold": self.ring_threshold,
                "ring_prefills": self.ring_prefills,
                "ring_prefilled_tokens": self.ring_prefilled_tokens,
                "ring_prefill_s": self.ring_prefill_s,
                "fallbacks": self.longctx_fallbacks,
            },
            "tp": tp_size(self.mesh),
            "ep": self.mesh.shape["ep"] if self.mesh is not None else 1,
            "sp": self.mesh.shape["sp"] if self.mesh is not None else 1,
            "graphs": self.device.type == "cuda" and self.graphs_off is None,
            "graphs_off": self.graphs_off,
        }
