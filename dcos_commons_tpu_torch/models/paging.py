"""Host-side page ledger + prefix-sharing radix for the paged serving
engine (copied from ``dcos_commons_tpu/models/paging.py``; the port
imports nothing of the JAX package).

The device side of paged serving is a fixed pool of KV pages
(``llama.init_page_pool``) consulted through per-stream page tables;
this module is the HOST side: who owns which physical page. Every page
is either free or refcounted, transitions are explicit (alloc/ref/unref),
and :meth:`PagePool.check` audits the whole ledger.

Sharing model (prefix caching): only FULL pages of prompt tokens are
hash-consed, since a page whose every position is fixed by the prompt
has identical K/V across requests; a retiring stream's full prompt pages
are adopted into the radix; the partial boundary page is copied eagerly
at admission (copy-on-write), so every page a stream writes is private.

Page hashes are byte-identical to the reference's, so a port replica
and a JAX replica agree on what a prefix is. Host/disk tiers, page
frames and the fleet prefix directory are not ported yet.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


def page_hashes(prompt: Sequence[int], page_size: int) -> List[str]:
    """Content hash per FULL page of prompt tokens: one blake2s over the
    page's int32 bytes, truncated to 16 hex chars; the partial tail is
    excluded (a partial page is never position-aligned shareable)."""
    out = []
    for j in range(len(prompt) // page_size):
        page = np.asarray(prompt[j * page_size:(j + 1) * page_size],
                          np.int32)
        out.append(hashlib.blake2s(page.tobytes()).hexdigest()[:16])
    return out


class PageLedgerError(RuntimeError):
    """A page transition that must never happen (double free, ref of a
    free page): raised loudly rather than corrupting shared K/V."""


class PagePool:
    """Refcounted ledger over ``pages`` physical KV pages.

    Pure host bookkeeping: it never touches the device pool; the serving
    engine translates (alloc/unref) into page-table edits.
    """

    def __init__(self, pages: int, page_size: int):
        if pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got {pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pages = pages
        self.page_size = page_size
        self._ref = [0] * pages
        # pop() from the tail -> ascending allocation order
        self._free = list(range(pages - 1, -1, -1))
        self.in_use_peak = 0

    # ------------------------------------------------------------ queries

    def free_count(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # -------------------------------------------------------- transitions

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or None when fewer than ``n``
        are free (all-or-nothing: a partial grant would strand a stream
        mid-prefill with nowhere to write)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        self.in_use_peak = max(self.in_use_peak, self.in_use())
        return out

    def ref(self, page: int) -> None:
        """One more reference to a live page (prefix sharing)."""
        if not 0 <= page < self.pages:
            raise PageLedgerError(f"ref of unknown page {page}")
        if self._ref[page] <= 0:
            raise PageLedgerError(
                f"ref of free page {page}: sharing a page nobody owns")
        self._ref[page] += 1

    def unref(self, page: int) -> None:
        """Drop one reference; the page returns to the free list at 0."""
        if not 0 <= page < self.pages:
            raise PageLedgerError(f"unref of unknown page {page}")
        if self._ref[page] <= 0:
            raise PageLedgerError(f"double free of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    # ---------------------------------------------------- audit + recovery

    def check(self, expected_refs: Optional[Mapping[int, int]] = None
              ) -> List[str]:
        """Ledger violations (empty == healthy).

        Structural: refcounts non-negative, the free list and the
        refcounts agree (a page is free iff refcount 0), no duplicate
        free-list entries. With ``expected_refs`` (page -> references
        actually held by live page tables + the radix) also cross-checks
        that no page leaked or is double-booked.
        """
        out: List[str] = []
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            dupes = sorted({p for p in self._free
                            if self._free.count(p) > 1})
            out.append(f"free list holds duplicates {dupes}: a double "
                       "free put the same page up for grabs twice")
        for p in range(self.pages):
            r = self._ref[p]
            if r < 0:
                out.append(f"page {p}: negative refcount {r}")
            elif r == 0 and p not in free_set:
                out.append(f"page {p}: leaked (refcount 0 but not in "
                           "the free list)")
            elif r > 0 and p in free_set:
                out.append(f"page {p}: double-booked (refcount {r} "
                           "while on the free list)")
        if expected_refs is not None:
            for p in range(self.pages):
                want = expected_refs.get(p, 0)
                if self._ref[p] != want:
                    out.append(
                        f"page {p}: refcount {self._ref[p]} != {want} "
                        "references held by live tables/radix")
        return out

    def reconcile(self, expected_refs: Mapping[int, int]) -> List[int]:
        """Crash-recovery sweep: force the ledger to the reference
        counts derivable from surviving state (live page tables + the
        radix) and rebuild the free list. Returns the reclaimed page ids
        (pages the crash left counted but unreferenced)."""
        reclaimed = []
        for p in range(self.pages):
            want = expected_refs.get(p, 0)
            if self._ref[p] > 0 and want == 0:
                reclaimed.append(p)
            self._ref[p] = want
        self._free = [p for p in range(self.pages - 1, -1, -1)
                      if self._ref[p] == 0]
        return reclaimed


class _Node:
    __slots__ = ("children", "page", "parent", "key", "stamp")

    def __init__(self, parent: Optional["_Node"],
                 key: Optional[tuple], page: Optional[int]):
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.key = key
        self.page = page
        self.stamp = 0


class PrefixRadix:
    """Hash-consed radix of full prompt-prefix pages.

    Each edge is one page's worth of prompt tokens (the tuple is the
    hash-cons key); each non-root node owns ONE reference to a physical
    page in the :class:`PagePool`. Lookups reference matched pages on
    the caller's behalf; retirement adopts new pages via :meth:`insert`;
    :meth:`evict` trims least-recently-used unshared leaves when the
    pool runs dry.
    """

    def __init__(self, pool: PagePool):
        self._pool = pool
        self._root = _Node(None, None, None)
        self._clock = 0
        self.hits = 0            # lookups that shared >= 1 page
        self.shared_pages = 0    # pages served from the radix, cumulative

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- lookup

    def lookup(self, prompt: List[int]) -> Tuple[List[int], _Node]:
        """Longest cached chain of full pages covering a PROPER prefix
        of ``prompt``; takes one pool reference per matched page on the
        caller's behalf. At least one prompt token is always left
        uncached so the final prefill chunk has a live position to take
        first-token logits from. Returns (pages, stop_node): feed the
        stop node to :meth:`boundary` for the partial-page tail."""
        ps = self._pool.page_size
        n = len(prompt)
        node, pages = self._root, []
        j = 0
        while (j + 1) * ps < n:
            child = node.children.get(tuple(prompt[j * ps:(j + 1) * ps]))
            if child is None:
                break
            self._pool.ref(child.page)
            child.stamp = self._tick()
            pages.append(child.page)
            node = child
            j += 1
        if pages:
            self.hits += 1
            self.shared_pages += len(pages)
        return pages, node

    def boundary(self, node: _Node, prompt: List[int],
                 matched_tokens: int) -> Optional[Tuple[int, int]]:
        """Partial-page tail match under ``node``: a cached child whose
        page STARTS with the next (shareable) prompt tokens. Returns
        (src_page, valid_tokens) or None. The caller must COPY the page
        (eager copy-on-write): the source stays owned by the radix, and
        positions past ``valid_tokens`` in the copy are garbage the
        caller's prefill/decode writes overwrite."""
        ps = self._pool.page_size
        valid = min(ps - 1, len(prompt) - 1 - matched_tokens)
        if valid <= 0:
            return None
        want = tuple(prompt[matched_tokens:matched_tokens + valid])
        for key, child in node.children.items():
            if key[:valid] == want:
                child.stamp = self._tick()
                return child.page, valid
        return None

    # ------------------------------------------------------------- insert

    def insert(self, prompt: List[int], pages: List[int]) -> int:
        """Adopt a retiring stream's full prompt pages (hash-consing:
        an existing node keeps ITS page and the stream's duplicate is
        simply not adopted; a new node takes one reference on the
        stream's page). Returns how many pages were newly adopted."""
        ps = self._pool.page_size
        node, adopted = self._root, 0
        full = min(len(prompt) // ps, len(pages))
        for j in range(full):
            key = tuple(prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key, pages[j])
                self._pool.ref(pages[j])
                node.children[key] = child
                adopted += 1
            child.stamp = self._tick()
            node = child
        return adopted

    # ----------------------------------------------------- evict + audit

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def held(self) -> Dict[int, int]:
        """page -> references the radix holds (the invariant checker's
        input alongside the live page tables)."""
        out: Dict[int, int] = {}
        for node in self._iter_nodes():
            out[node.page] = out.get(node.page, 0) + 1
        return out

    def evict(self, need: int) -> int:
        """Drop least-recently-used childless nodes nobody else
        references until ``need`` pages came free (or no candidates
        remain). Shared nodes (an active stream still references the
        page) are kept: unref'ing them frees nothing now and forfeits
        the share. Returns pages actually freed."""
        freed = 0
        while freed < need:
            leaves = [n for n in self._iter_nodes()
                      if not n.children
                      and self._pool.refcount(n.page) == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda x: x.stamp)
            del victim.parent.children[victim.key]
            self._pool.unref(victim.page)
            freed += 1
        return freed
