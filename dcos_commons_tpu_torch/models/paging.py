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
and a JAX replica agree on what a prefix is.

KV hierarchy: a radix page evicted under pressure goes through ONE
demote seam (:meth:`PrefixRadix.evict`'s ``demoter``) into a
:class:`PageTierStore` as a KVPAGE1 frame (:func:`pack_page_frame`,
byte-identical to the reference's for the same payload), host first,
spilling to disk; a :class:`PrefixDirectory` tells a replica which
sibling holds a prefix. Payloads are CPU torch tensors (or numpy
arrays), ``[L, N, page, KV, D]`` per side, ``{"q", "s"}`` for int8
pools; bf16 crosses the frame through a ``uint16`` view, so no
``ml_dtypes`` is needed, and the dtype travels with the tensor.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

# dtype names as numpy (and the reference's ml_dtypes) spell them
from ..parallel.checkpoint import _DTYPE_NAMES


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


def chain_keys(prompt: Sequence[int], page_size: int) -> List[str]:
    """Position-aligned CHAIN identity per full-page prefix: entry ``j``
    keys the whole prefix ``prompt[:(j + 1) * page_size]`` (the
    :func:`page_hashes` folded through one running blake2s), since
    prefix K/V is only valid for the exact token run that produced it.
    The tiers and the prefix directory address pages by it."""
    out: List[str] = []
    acc = hashlib.blake2s()
    for h in page_hashes(prompt, page_size):
        acc.update(h.encode())
        out.append(acc.copy().hexdigest()[:16])
    return out


class PageLedgerError(RuntimeError):
    """A page transition that must never happen (double free, ref of a
    free page): raised loudly rather than corrupting shared K/V."""


class PageFrameError(RuntimeError):
    """A demoted page frame that must not be promoted: framing, digest
    or identity verification failed (bit-rot on disk, a truncated write,
    a frame filed under the wrong chain)."""


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

    def size(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    def held(self) -> Dict[int, int]:
        """page -> references the radix holds (the invariant checker's
        input alongside the live page tables)."""
        out: Dict[int, int] = {}
        for node in self._iter_nodes():
            out[node.page] = out.get(node.page, 0) + 1
        return out

    def prefix_tokens(self, node: _Node) -> List[int]:
        """The full token run root -> ``node`` (a multiple of
        ``page_size`` tokens): the identity a demoter files the node's
        page under."""
        parts = []
        while node.parent is not None:
            parts.append(node.key)
            node = node.parent
        out: List[int] = []
        for key in reversed(parts):
            out.extend(key)
        return out

    def evict(self, need: int, demoter: Optional[Callable] = None) -> int:
        """Drop least-recently-used childless nodes nobody else
        references until ``need`` pages came free (or no candidates
        remain). Shared nodes (an active stream still references the
        page) are kept: unref'ing them frees nothing now and forfeits
        the share. Returns pages actually freed.

        ``demoter`` is THE single demote seam: called as
        ``demoter(page, prefix_tokens)`` for every victim BEFORE the
        unref, while the page still holds its last reference, so its
        device content may be gathered and filed in a colder tier."""
        freed = 0
        while freed < need:
            leaves = [n for n in self._iter_nodes()
                      if not n.children
                      and self._pool.refcount(n.page) == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda x: x.stamp)
            del victim.parent.children[victim.key]
            if demoter is not None:
                demoter(victim.page, self.prefix_tokens(victim))
            self._pool.unref(victim.page)
            freed += 1
        return freed

    def clear(self) -> None:
        """Release every cached page (the device pool's content is
        gone)."""
        for node in list(self._iter_nodes()):
            self._pool.unref(node.page)
        self._root.children = {}


# ---------------------------------------------------------------------------
# arrays on the wire: the layout KVPAGE1 frames and KVSPAN spans share


def flatten_payload(payload: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """A K/V payload as a flat (key, array) list in a FIXED order, the
    wire layout: ``k``, ``v``, or ``k.q``, ``k.s``, ``v.q``, ``v.s`` for
    int8 pools."""
    out: List[Tuple[str, Any]] = []
    for side in ("k", "v"):
        val = payload[side]
        if isinstance(val, dict):
            out.append((f"{side}.q", val["q"]))
            out.append((f"{side}.s", val["s"]))
        else:
            out.append((side, val))
    return out


def host_array(x: Any) -> Tuple[str, List[int], np.ndarray]:
    """(dtype name, shape, C-order host array whose bytes go on the
    wire) of a tensor (bf16 through a ``uint16`` view) or an array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        name = _DTYPE_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(x.shape), np.ascontiguousarray(t.numpy())
    a = np.asarray(x)
    return a.dtype.name, list(a.shape), np.ascontiguousarray(a)


def pack_arrays(arrays: List[Tuple[str, Any]]
                ) -> Tuple[List[dict], bytes]:
    """(array specs, body): each array's key, shape and dtype name, and
    their bytes back to back, as the reference writes them."""
    specs, parts = [], []
    for key, x in arrays:
        name, shape, a = host_array(x)
        specs.append({"key": key, "shape": shape, "dtype": name})
        parts.append(a.reshape(-1).view(np.uint8))
    return specs, b"".join(parts)


def unpack_arrays(body, specs: List[dict], error: type
                  ) -> Dict[str, torch.Tensor]:
    """The arrays ``specs`` name, read from ``body`` in order as CPU
    tensors (``bfloat16`` through ``uint16``). Any structural surprise
    (an unknown dtype, a bad shape, a body cut short) raises ``error``."""
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    try:
        for spec in specs:
            name = spec["dtype"]
            if name not in _DTYPE_NAMES.values():
                raise error(f"unknown dtype {name!r}")
            dt = np.dtype(np.uint16 if name == "bfloat16" else name)
            shape = tuple(int(d) for d in spec["shape"])
            count = int(np.prod(shape))
            nbytes = dt.itemsize * count
            if pos + nbytes > len(body):
                raise error(f"truncated body at {spec['key']!r}")
            a = np.frombuffer(body, dt, count=count,
                              offset=pos).reshape(shape).copy()
            t = torch.from_numpy(a)
            out[spec["key"]] = (t.view(torch.bfloat16)
                                if name == "bfloat16" else t)
            pos += nbytes
    except error:
        raise
    except Exception as e:
        raise error(f"bad array specs: {e}") from None
    return out


def payload_from_arrays(arrays: Dict[str, torch.Tensor], error: type,
                        what: str) -> Dict[str, Any]:
    """The ``{"k", "v"}`` payload (``{"q", "s"}`` per side for int8)
    of unpacked arrays; ``error`` when a side is missing."""
    payload: Dict[str, Any] = {}
    for side in ("k", "v"):
        if side in arrays:
            payload[side] = arrays[side]
        elif f"{side}.q" in arrays and f"{side}.s" in arrays:
            payload[side] = {"q": arrays[f"{side}.q"],
                             "s": arrays[f"{side}.s"]}
        else:
            raise error(f"frame missing the {side!r} {what}")
    return payload


# ---------------------------------------------------------------------------
# demoted-page frames (KVPAGE1)


_FRAME_MAGIC = b"KVPAGE1\0"
_FRAME_VERSION = 1


def pack_page_frame(entry: Dict[str, Any]) -> bytes:
    """Frame ONE demoted KV page for the host/disk tiers: ``MAGIC |
    header_len | header JSON | raw array bytes``. The header carries the
    chain key and page hash the frame is filed under, and one blake2s
    digest over the canonical header and the body, so a promote proves
    the bytes it installs are exactly the bytes demoted."""
    specs, body = pack_arrays(flatten_payload(entry["payload"]))
    meta = {
        "version": _FRAME_VERSION,
        "chain": str(entry["chain"]),
        "page_hash": str(entry["page_hash"]),
        "kv_quant": bool(entry.get("kv_quant", False)),
        "arrays": specs,
    }
    # a flipped bit in the metadata (chain, shapes, dtype) is as fatal
    # as one in the K/V bytes
    meta["digest"] = hashlib.blake2s(
        json.dumps(meta, sort_keys=True).encode() + body).hexdigest()
    header = json.dumps(meta).encode()
    return _FRAME_MAGIC + struct.pack("<I", len(header)) + header + body


def unpack_page_frame(data: bytes,
                      chain: Optional[str] = None) -> Dict[str, Any]:
    """Parse and VERIFY a demoted-page frame: magic, version, digest and
    (when given) the chain key the caller is promoting. Raises
    :class:`PageFrameError` on any mismatch, so a corrupt tier entry is
    dropped holding zero pool pages."""
    if not data.startswith(_FRAME_MAGIC):
        raise PageFrameError("bad magic: not a KV page frame")
    off = len(_FRAME_MAGIC)
    if len(data) < off + 4:
        raise PageFrameError("truncated frame: no header length")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    if len(data) < off + hlen:
        raise PageFrameError("truncated frame: header cut short")
    try:
        meta = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise PageFrameError(f"bad header: {e}") from None
    if not isinstance(meta, dict):
        raise PageFrameError("bad header: not an object")
    off += hlen
    if meta.get("version") != _FRAME_VERSION:
        raise PageFrameError(f"frame version {meta.get('version')} != "
                             f"{_FRAME_VERSION}")
    if chain is not None and meta.get("chain") != chain:
        raise PageFrameError(f"frame filed under chain "
                             f"{meta.get('chain')!r}, wanted {chain!r}")
    body = memoryview(data)[off:]
    core = {k: v for k, v in meta.items() if k != "digest"}
    want = hashlib.blake2s(
        json.dumps(core, sort_keys=True).encode() + body).hexdigest()
    if want != meta.get("digest"):
        raise PageFrameError("digest mismatch: corrupt frame")
    # past the digest everything re-derives from verified bytes, but a
    # flipped bit can still yield VALID JSON with mangled specs
    arrays = unpack_arrays(body, meta.get("arrays", []), PageFrameError)
    payload = payload_from_arrays(arrays, PageFrameError, "page")
    return {"version": meta["version"], "chain": meta["chain"],
            "page_hash": meta["page_hash"],
            "kv_quant": meta["kv_quant"], "payload": payload}


# ---------------------------------------------------------------------------
# host/disk page tiers


def _unlink(paths: List[str]) -> None:
    for path in paths:
        try:
            os.remove(path)
        except OSError:
            pass


class PageTierStore:
    """Cold-page hierarchy under the device pool: demoted radix pages
    live here as packed, digest-checked frames, in host memory first,
    spilling to content-addressed files on disk when the host tier
    fills, dropping the LRU frame when disk fills too. Capacity is
    counted in PAGES on both tiers.

    Ownership: the store holds BYTE COPIES keyed by chain key, never
    pool page ids, so the page ledger has nothing new to prove.
    :meth:`take` POPS (the caller becomes the frame's only owner, and a
    racing promote misses and recomputes); :meth:`discard` drops a chain
    the radix re-acquired, so content lives in the radix XOR the tiers.
    A frame failing verification at :meth:`take` is counted, dropped and
    reported as a miss. Thread-safe; disk I/O runs outside the lock."""

    def __init__(self, host_pages: int = 0,
                 disk_dir: Optional[str] = None, disk_pages: int = 0):
        if host_pages < 0 or disk_pages < 0:
            raise ValueError("tier capacities must be >= 0")
        if disk_pages > 0 and not disk_dir:
            raise ValueError("disk_pages > 0 needs disk_dir")
        self.host_pages = int(host_pages)
        self.disk_pages = int(disk_pages) if disk_dir else 0
        self.disk_dir = disk_dir
        if disk_dir and self.disk_pages > 0:
            os.makedirs(disk_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._host: "OrderedDict[str, bytes]" = OrderedDict()
        self._disk: "OrderedDict[str, str]" = OrderedDict()  # chain->path
        self.demoted_host = 0     # frames filed into the host tier
        self.demoted_disk = 0     # frames spilled host -> disk
        self.dropped = 0          # LRU frames dropped off the disk end
        self.host_hits = 0
        self.disk_hits = 0
        self.misses = 0
        self.corrupt_frames = 0   # frames rejected at take
        self.discarded = 0        # chains the radix re-acquired

    # ------------------------------------------------------------ queries

    def host_count(self) -> int:
        with self._lock:
            return len(self._host)

    def disk_count(self) -> int:
        with self._lock:
            return len(self._disk)

    def has(self, chain: str) -> bool:
        with self._lock:
            return chain in self._host or chain in self._disk

    def chains(self) -> List[str]:
        with self._lock:
            return list(self._host) + list(self._disk)

    # -------------------------------------------------------- transitions

    def put(self, chain: str, entry: Dict[str, Any]) -> None:
        """Demote: pack ``entry`` (``chain`` / ``page_hash`` /
        ``kv_quant`` / one-page ``payload``) and file it, displacing LRU
        frames down the hierarchy (host -> disk -> dropped). A
        re-demoted chain replaces its stale frame."""
        frame = pack_page_frame(entry)
        spill: List[Tuple[str, bytes]] = []
        unlink: List[str] = []
        with self._lock:
            self._pop_locked(chain, unlink)
            if self.host_pages > 0:
                self._host[chain] = frame
                self.demoted_host += 1
                while len(self._host) > self.host_pages:
                    spill.append(self._host.popitem(last=False))
            else:
                spill.append((chain, frame))
        for old_chain, old_frame in spill:
            self._spill(old_chain, old_frame, unlink)
        _unlink(unlink)

    def _spill(self, chain: str, frame: bytes, unlink: List[str]) -> None:
        """File one frame host -> disk, with ``_lock`` RELEASED: the
        write lands first (atomically), the ledger entry commits under
        the lock after; displaced paths go to ``unlink``."""
        if self.disk_pages <= 0:
            with self._lock:
                self.dropped += 1
            return
        path = os.path.join(self.disk_dir, f"{chain}.kvpage")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame)
        os.replace(tmp, path)
        with self._lock:
            self._disk[chain] = path
            self._disk.move_to_end(chain)
            self.demoted_disk += 1
            while len(self._disk) > self.disk_pages:
                _, old_path = self._disk.popitem(last=False)
                unlink.append(old_path)
                self.dropped += 1

    def take(self, chain: str) -> Optional[Dict[str, Any]]:
        """Promote: POP the chain's frame, verify it and return the
        decoded entry, or None on a miss or a corrupt frame (counted; the
        frame is gone either way). The pop is the ownership transfer and
        happens under ``_lock``; the disk read does not."""
        path: Optional[str] = None
        with self._lock:
            frame = self._host.pop(chain, None)
            from_host = frame is not None
            if frame is None:
                path = self._disk.pop(chain, None)
                if path is None:
                    self.misses += 1
                    return None
        if frame is None:
            try:
                with open(path, "rb") as f:
                    frame = f.read()
            except OSError:
                frame = b""
            _unlink([path])
        try:
            entry = unpack_page_frame(frame, chain=chain)
        except PageFrameError:
            with self._lock:
                self.corrupt_frames += 1
                self.misses += 1
            return None
        with self._lock:
            if from_host:
                self.host_hits += 1
            else:
                self.disk_hits += 1
        return entry

    def discard(self, chain: str) -> bool:
        """Drop a chain without reading it: the radix owns the content
        again, so a tier copy would make two owners."""
        unlink: List[str] = []
        with self._lock:
            hit = self._pop_locked(chain, unlink)
            if hit:
                self.discarded += 1
        _unlink(unlink)
        return hit

    def _pop_locked(self, chain: str, unlink: List[str]) -> bool:
        """Drop ``chain`` from both tier ledgers; an orphaned disk path
        goes to ``unlink`` for removal outside the lock."""
        hit = self._host.pop(chain, None) is not None
        path = self._disk.pop(chain, None)
        if path is not None:
            hit = True
            unlink.append(path)
        return hit

    def clear(self) -> None:
        with self._lock:
            self._host.clear()
            paths = list(self._disk.values())
            self._disk.clear()
        _unlink(paths)

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "host_pages": len(self._host),
                "host_capacity": self.host_pages,
                "disk_pages": len(self._disk),
                "disk_capacity": self.disk_pages,
                "demoted_host": self.demoted_host,
                "demoted_disk": self.demoted_disk,
                "dropped": self.dropped,
                "host_hits": self.host_hits,
                "disk_hits": self.disk_hits,
                "misses": self.misses,
                "corrupt_frames": self.corrupt_frames,
                "discarded": self.discarded,
            }


# ---------------------------------------------------------------------------
# fleet prefix directory


class PrefixDirectory:
    """Fleet-wide map of WHO holds WHICH cached prefix, keyed by
    :func:`chain_keys`. Replicas publish the chains their radix adopts;
    a replica that misses locally asks for a sibling to ADOPT the prefix
    from over the span transport instead of recomputing it.

    Entries are hints, never truth: :meth:`lookup` drops claims older
    than ``max_age_s``, and a stale hint costs the asker one failed
    fetch and a recompute, never a wrong answer (the span transport
    verifies what arrives). Thread-safe."""

    def __init__(self, max_age_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_age_s = float(max_age_s)
        self._clock = clock
        self._lock = threading.Lock()
        # chain -> {replica: publish stamp}
        self._holders: Dict[str, Dict[str, float]] = {}
        self.publishes = 0
        self.hits = 0
        self.misses = 0
        self.stale_drops = 0

    def publish(self, replica: str, chains: Sequence[str]) -> None:
        now = self._clock()
        with self._lock:
            for chain in chains:
                self._holders.setdefault(chain, {})[replica] = now
                self.publishes += 1

    def forget(self, replica: str) -> None:
        """Drop every hint naming ``replica`` (it restarted or left)."""
        with self._lock:
            for chain in list(self._holders):
                self._holders[chain].pop(replica, None)
                if not self._holders[chain]:
                    del self._holders[chain]

    def lookup(self, chain: str,
               exclude: Optional[str] = None) -> Optional[str]:
        """Freshest replica claiming ``chain`` (excluding the asker), or
        None. Stale claims are dropped on the way through."""
        horizon = self._clock() - self.max_age_s
        with self._lock:
            holders = self._holders.get(chain)
            if holders:
                for replica in [r for r, t in holders.items()
                                if t < horizon]:
                    del holders[replica]
                    self.stale_drops += 1
                if not holders:
                    del self._holders[chain]
                    holders = None
            if not holders:
                self.misses += 1
                return None
            best = max((r for r in holders if r != exclude),
                       key=lambda r: holders[r], default=None)
            if best is None:
                self.misses += 1
                return None
            self.hits += 1
            return best

    def holders(self, chain: str) -> List[str]:
        with self._lock:
            return sorted(self._holders.get(chain, ()))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "chains": len(self._holders),
                "publishes": self.publishes,
                "hits": self.hits,
                "misses": self.misses,
                "stale_drops": self.stale_drops,
            }
