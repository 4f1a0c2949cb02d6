"""Block-paged continuous batching (port of ``PagedServer`` in
``dcos_commons_tpu/models/serving.py``).

One device pool of fixed ``(page_size, KV, D)`` K/V pages (+ one scratch
page) serves every stream through a per-stream page table; admission is
gated on pages free (the host ledger, ``models.paging.PagePool``); full
prompt-prefix pages are shared through a radix with an eager
copy-on-write of the boundary page; prompts prefill in fixed chunks, one
chunk per decode step, interleaved with decode.

Differences from the reference, all mechanical:

* the ``lax.scan`` decode window is a Python loop of
  ``llama.decode_step_paged`` calls; tokens stay on the device and the
  window ends with ONE host transfer;
* the pool is updated in place;
* not ported yet, and refused by the constructor (no such parameter):
  KV tiers, the prefix directory, disaggregation, migration,
  speculative decoding, MoE, ring prefill, the AOT compile cache and
  tensor-parallel meshes.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.quant import QTensor
from ..ops.rotary import rope_frequencies
from ..ops.sampling import Sampler
from . import llama
from .paging import PagePool, PrefixRadix


@dataclasses.dataclass
class _Request:
    request_id: Any
    prompt_len: int
    budget: int
    tokens: List[int]


def _copy_page(cache, src: int, dst: int) -> None:
    """Copy pool page ``src`` -> ``dst`` across every layer (payload +
    scales for int8 pools), in place: the eager copy-on-write of a
    prefix-cached boundary page at admission."""
    if isinstance(cache, QTensor):
        cache.q[:, dst] = cache.q[:, src]
        cache.s[:, dst] = cache.s[:, src]
    else:
        cache[:, dst] = cache[:, src]


class PagedServer:
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

    ``params`` must live on ``device``.
    """

    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 pages: Optional[int] = None, page_size: int = 64,
                 prefill_chunk: int = 64, sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, prefix_cache: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if page_size < 1 or cfg.max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq "
                f"{cfg.max_seq} (the page table is fixed-width)")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        embed = params["embed"]
        params_dev = (embed.q if isinstance(embed, QTensor) else embed).device
        if params_dev.type != self.device.type:
            raise ValueError(f"params live on {params_dev}, the engine on "
                             f"{self.device}")
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
        self._rope = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                      cfg.rope_theta, device=self.device)
        self._prefix_cache = prefix_cache
        self.reset()

    def reset(self) -> None:
        """Rebuild device + host state (a failed step may leave the pool
        half-written). The radix is rebuilt too: its cached K/V lived in
        the old pool."""
        self.pool = llama.init_page_pool(self.cfg, self.total_pages + 1,
                                         self.page_size, device=self.device)
        self.ledger = PagePool(self.total_pages, self.page_size)
        self.radix = (PrefixRadix(self.ledger) if self._prefix_cache
                      else None)
        self._tables = np.full((self.slots, self.pages_per_stream),
                               self.scratch, np.int32)
        self.lengths = torch.zeros((self.slots,), dtype=torch.int32,
                                   device=self.device)
        self.cur_tok = torch.zeros((self.slots,), dtype=torch.int32,
                                   device=self.device)
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

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    def requests_active(self) -> bool:
        return any(r is not None for r in self.requests)

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

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        if self.sampler is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return self.sampler(self.generator, logits).to(torch.int32)

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
            self.scratch, rope=self._rope)
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
        dead steps, as in the reference's fixed-mask scan."""
        return self._decode(max(k, 1))

    def _decode(self, k: int) -> Dict[int, List[int]]:
        self._flush_pending()
        for _ in range(k):
            self._prefill_tick()
            if not self._prefill_q:
                break
        active = self._active()
        if not active:
            return {}
        mask = torch.zeros((self.slots,), dtype=torch.bool,
                           device=self.device)
        mask[active] = True
        mp = self._window_mp(active, k)
        tbl = torch.tensor(self._decode_tables()[:, :mp],
                           device=self.device)
        ln, tok = self.lengths, self.cur_tok
        window = []
        for _ in range(k):
            logits, self.pool = llama.decode_step_paged(
                self.cfg, self.params, self.pool, tbl, ln, tok,
                rope=self._rope)
            nxt = torch.where(mask, self._select(logits), tok)
            ln = torch.where(mask, ln + 1, ln)
            tok = nxt
            window.append(nxt)
        self.lengths, self.cur_tok = ln, tok
        host = torch.stack(window).cpu().numpy()        # ONE transfer
        out: Dict[int, List[int]] = {}
        for i in active:
            emitted: List[int] = []
            r = self.requests[i]
            for t in host[:, i]:
                emitted.append(int(t))
                r.tokens.append(int(t))
                self._maybe_retire(i)
                if self.requests[i] is None:
                    break   # retired mid-window: the rest is dead compute
            out[i] = emitted
        return out

    def drain(self, queue: List[Dict[str, Any]],
              decode_window: int = 1) -> Dict[Any, List[int]]:
        """Serve a whole workload: submit as streams free up, step until
        every request finishes. Each queue item: {"prompt": [...],
        "max_new": int, "request_id": any}. ``decode_window > 1``
        amortizes the host round trip over a window of steps."""
        pending = list(queue)
        while pending or self.requests_active():
            placed = self.submit_many(pending)
            pending = pending[len(placed):]
            self.step_many(decode_window)
        return dict(self.finished)

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
        }
