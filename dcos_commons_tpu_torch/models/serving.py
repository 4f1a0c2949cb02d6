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
  through ``llama.make_moe_ffn``, on the local path (every expert on the
  engine's device); each captured window holds the routing;
* not ported yet, and refused by the constructors (no such parameter):
  tensor-parallel meshes and, for the paged engine, KV tiers, the prefix
  directory, disaggregation, migration, ring prefill and expert-parallel
  meshes.
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
from ..ops.quant import QArray, QTensor, qmm, quantize
from ..ops.rotary import rope_frequencies
from ..ops.sampling import Sampler
from ..parallel.aot import CompileCache, engine_key
from ..parallel.moe import MoEConfig
from . import llama
from .paging import PagePool, PrefixRadix


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
                         rope):
    """[N, P] causal forward for N admitted prompts: (logits [N, V] fp32
    at each row's last live position ``true_lens - 1``, ks/vs
    [L, N, P, KV, D]). Positions past a row's length are causally
    downstream of its live ones and change nothing they read."""
    x, ks, vs = llama.prefill_trunk(cfg, params, prompts, rope)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, true_lens.long() - 1]
    return qmm(last, params["lm_head"]).float(), ks, vs


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
        if self.device.type != "cuda":
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
                "capture_s": self.capture_s, "pool_bytes": pool_bytes}

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

    ``params`` must live on ``device``.
    """

    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        llama.check_params_device(params, self.device, "engine")
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
                                         device=self.device)
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
            self._rope)
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
            rope=self._rope)
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

    ``params`` must live on ``device``.
    """

    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 pages: Optional[int] = None, page_size: int = 64,
                 prefill_chunk: int = 64, sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, prefix_cache: bool = True,
                 compile_cache: Optional[CompileCache] = None,
                 moe: Optional[MoEConfig] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
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
        self._ffn = (llama.make_moe_ffn(cfg, moe)
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
                cfg, None, device=self.device, kind="paged", slots=slots,
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
                                         page_size, device=self.device)
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
        re-allocates it; here the spec graphs bind it)."""
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

    def _evict(self, need: int) -> int:
        """The single release path for radix pages under pressure."""
        return self.radix.evict(need)

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
        if node is not None:
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
        self._prefill_q.append(slot)
        return slot

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

    def _prefill_tick(self) -> None:
        """Run ONE fixed-shape prefill chunk for the stream at the head
        of the prefill queue."""
        while self._prefill_q and self.requests[self._prefill_q[0]] is None:
            self._prefill_q.popleft()          # aborted mid-prefill
        if not self._prefill_q:
            return
        slot = self._prefill_q[0]
        prompt = self._prompts[slot]
        n = len(prompt)
        c = self.prefill_chunk
        start = self._prefill_pos[slot]
        end = min(start + c, n)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :end - start] = prompt[start:end]
        last = end >= n
        li = (n - 1 - start) if last else 0
        dev = self.device
        logits, self.pool = llama.prefill_chunk_paged(
            self.cfg, self.params, self.pool,
            torch.tensor(self._tables[slot], device=dev),
            torch.tensor(chunk, device=dev), start, n, li,
            self.scratch, rope=self._rope, ffn_override=self._ffn)
        self._prefill_pos[slot] = end
        if last:
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
            tokens, rope=self._rope, ffn_override=self._ffn)
        return logits

    def _decode(self, k: int) -> Dict[int, List[int]]:
        self._flush_pending()
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

    def warmup(self, widths=(1,)) -> Dict[str, float]:
        """The cold-start ``compile`` phase before admission: one prefill
        chunk, then the one-step window of each decode-table width in
        ``widths`` captured as a CUDA graph (on CUDA) and run once, every
        write landing on the scratch page and no length or token
        advancing. Windows of other sizes or widths are captured at
        first use. Returns ``{phase: seconds}`` with the reference's
        keys (``chunk``, ``step_w<w>``)."""
        widths = [int(w) for w in widths]
        for w in widths:
            if not 1 <= w <= self.pages_per_stream:
                raise ValueError(f"warmup width {w} outside [1, "
                                 f"{self.pages_per_stream}]")
        timings: Dict[str, float] = {}
        dev = self.device
        t0 = time.perf_counter()
        row = torch.full((self.pages_per_stream,), self.scratch,
                         dtype=torch.int32, device=dev)
        c = self.prefill_chunk
        logits, self.pool = llama.prefill_chunk_paged(
            self.cfg, self.params, self.pool, row,
            torch.zeros((1, c), dtype=torch.int32, device=dev), 0, c, c - 1,
            self.scratch, rope=self._rope, ffn_override=self._ffn)
        logits.cpu()
        timings["chunk"] = time.perf_counter() - t0
        for w in widths:
            t1 = time.perf_counter()
            self._table(w).fill_(self.scratch)
            self._run_window((1, w), [], lambda: self._window(1, w))
            timings[f"step_w{w}"] = time.perf_counter() - t1
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
            self.radix.insert(prompt, pages)
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
        }
