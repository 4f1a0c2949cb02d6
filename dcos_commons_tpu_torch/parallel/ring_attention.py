"""Ring attention: sequence-parallel blockwise attention over the ``sp``
axis of a process mesh (port of
``dcos_commons_tpu/parallel/ring_attention.py``).

The sequence is sharded over ``sp``: each rank holds queries
``[B, S/sp, H, D]`` and RAW keys and values ``[B, S/sp, KV, D]`` (the GQA
broadcast happens inside each tile's product, never in memory or on the
wire). Each hop computes one (query block x key block) tile with an fp32
online softmax, then passes the K/V block one rank on
(:meth:`parallel.mesh.Mesh.ppermute`).

Layouts, as the reference's:

* ``contiguous``: rank ``r`` holds positions ``[r S/sp, (r+1) S/sp)``.
  Under ``causal`` a hop whose block holds only later positions is
  skipped (the block still travels: later hops need it). The skip is
  decided on the host from ``(rank, hop)``, so it costs no device sync.
* ``zigzag``: the sequence is cut into ``2 sp`` chunks and rank ``r``
  holds chunks ``(r, 2 sp - 1 - r)``; every (query half, key half) pair
  computes when its query chunk is not before its key chunk, so every
  rank owns the same number of live half-tiles. Callers lay tokens out
  with :func:`zigzag_indices` (``models.llama.loss_fn`` does, and gives
  rope each slot's global position).

Unlike the reference, whose backward is XLA's transpose of its scan,
the whole call is ONE ``torch.autograd.Function`` (:class:`_RingAttention`):
its forward runs the ring (``sp - 1`` hops) and saves q, k, v, the fp32
output and each row's log-sum-exp; its backward recomputes each live
tile from them (FlashAttention-2) while the K/V blocks and their fp32
dK/dV accumulators travel the same way round, ``sp`` hops, so the
accumulators arrive home with every rank's share. Each rank skips
different hops, so per-hop autograd nodes would give the ranks different
graphs and let autograd order their collectives differently; one node
a call keeps every rank's hops in one fixed order. The tiles are plain
torch products (the reference's are ``jnp`` einsums outside any Pallas
kernel).

Per hop at ``[B, S, H, D]``, ring ``R``, group ``G = H / KV``: bytes sent
``2 B (S/R) KV D`` forward (K and V), ``4 B (S/R) KV D`` fp32 backward
(K, V and their gradients); a live tile does ``4 B H (S/R)^2 D`` FLOPs
forward.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_NEG = -1e30


def zigzag_indices(seq: int, ring: int) -> np.ndarray:
    """Gather order for the zigzag layout: position ``i`` of the laid-out
    sequence takes token ``zigzag_indices(S, R)[i]`` of the natural
    sequence. Shard ``r`` of the sp axis then holds natural chunks
    ``(r, 2R-1-r)``, each of size ``S / 2R``."""
    if seq % (2 * ring):
        raise ValueError(
            f"zigzag needs seq ({seq}) divisible by 2*ring ({2 * ring})")
    c = seq // (2 * ring)
    idx = []
    for r in range(ring):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * ring - 1 - r) * c, (2 * ring - r) * c))
    return np.asarray(idx, np.int32)


def ring_pad_len(n: int, ring: int, multiple: int = 1) -> int:
    """Smallest length >= ``n`` divisible by both ``ring`` and
    ``multiple`` (the reference's serving gang pads a prompt to it before
    a sequence-parallel prefill)."""
    if n <= 0:
        raise ValueError(f"prompt length must be positive, got {n}")
    m = ring * multiple // math.gcd(ring, multiple)
    return -(-n // m) * m


def zigzag_inverse(seq: int, ring: int) -> np.ndarray:
    """Scatter order undoing :func:`zigzag_indices` (natural <- laid-out)."""
    perm = zigzag_indices(seq, ring)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq, dtype=np.int32)
    return inv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, *, axis: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None,
                   layout: str = "contiguous") -> torch.Tensor:
    """This rank's attention output ``[B, S/sp, H, D]`` (``q``'s dtype)
    for its queries ``q`` ``[B, S/sp, H, D]`` over every rank's RAW
    ``k``/``v`` ``[B, S/sp, KV, D]`` (``H % KV == 0``; a caller may pass
    heads already repeated, ``KV == H``), in ``layout`` over ``axis`` of
    ``mesh`` (module doc). Without a mesh, or with ``axis`` of size 1,
    the ring is this rank alone."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} are not a multiple of "
                         f"the KV heads {k.shape[2]}")
    if layout == "zigzag" and q.shape[1] % 2:
        raise ValueError(
            f"zigzag needs an even local sequence, got {q.shape[1]}")
    return _RingAttention.apply(q, k, v, mesh, axis, causal, sm_scale,
                                layout)


class _Ring:
    """One call's geometry: the ring's size and this rank's place, the
    query halves (one for ``contiguous``, two for ``zigzag``) and which
    chunk of the natural sequence each shard's halves hold."""

    def __init__(self, q, k, mesh, axis, causal, sm_scale, layout):
        self.mesh, self.axis, self.causal = mesh, axis, causal
        self.device = q.device
        self.ring = mesh.shape[axis] if mesh is not None else 1
        self.me = mesh.coords[axis] if mesh is not None else 0
        b, s_local, h, d = q.shape
        kv = k.shape[2]
        self.shape = (b, s_local, h, d)
        self.kv, self.g = kv, h // kv
        self.scale = sm_scale if sm_scale is not None else d ** -0.5
        self.halves = 2 if layout == "zigzag" else 1
        self.c = s_local // self.halves

    def chunk_ids(self, shard: int) -> tuple:
        if self.halves == 2:
            return (shard, 2 * self.ring - 1 - shard)
        return (shard,)

    def grouped(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, S/sp, H, D]`` -> fp32 ``[B, halves, c, KV, G, D]``."""
        b, _, _, d = self.shape
        return x.float().reshape(b, self.halves, self.c, self.kv, self.g, d)

    def tiles(self, hop: int):
        """The live (query half, key half, mask or None) of ``hop``: the
        block this rank holds then is shard ``(me - hop) mod ring``'s."""
        mine = self.chunk_ids(self.me)
        src = self.chunk_ids((self.me - hop) % self.ring)
        for i, qc in enumerate(mine):
            for j, kc in enumerate(src):
                if not self.causal:
                    yield i, j, None
                elif qc > kc:
                    yield i, j, None               # every key is earlier
                elif qc == kc:
                    yield i, j, self.diagonal()
                # qc < kc: every key is later; the tile is skipped

    def diagonal(self) -> torch.Tensor:
        pos = torch.arange(self.c, device=self.device)
        return pos[:, None] >= pos[None, :]

    def block(self, kv: torch.Tensor, j: int) -> torch.Tensor:
        return kv[:, j * self.c:(j + 1) * self.c].float()

    def hop(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.ring == 1 else self.mesh.ppermute(x, self.axis, 1)

    def scores(self, qh, kb, mask):
        """``[B, KV, G, c, c]`` scores of query half ``qh`` (pre-scaled)
        over key block ``kb``, masked keys at ``_NEG``."""
        s = torch.einsum("bqkgd,bskd->bkgqs", qh, kb)
        return s if mask is None else torch.where(mask, s, _NEG)


class _RingAttention(torch.autograd.Function):
    """:func:`ring_attention`: the ring forward, the reverse ring
    backward (module doc)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale, layout):
        r = _Ring(q, k, mesh, axis, causal, sm_scale, layout)
        b, s_local, h, d = r.shape
        q32 = r.grouped(q) * r.scale
        state = [(torch.full((b, r.kv, r.g, r.c), _NEG, device=q.device),
                  torch.zeros((b, r.kv, r.g, r.c), device=q.device),
                  torch.zeros((b, r.kv, r.g, r.c, d), device=q.device))
                 for _ in range(r.halves)]
        kv = torch.stack([k, v])
        for t in range(r.ring):
            for i, j, mask in r.tiles(t):
                m, l, o = state[i]
                s = r.scores(q32[:, i], r.block(kv[0], j), mask)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                if mask is not None:
                    p = torch.where(mask, p, 0.0)  # kill masked ones
                alpha = torch.exp(m - m_new)
                state[i] = (m_new, l * alpha + p.sum(dim=-1),
                            o * alpha[..., None] + torch.einsum(
                                "bkgqs,bskd->bkgqd", p, r.block(kv[1], j)))
            if t < r.ring - 1:
                kv = r.hop(kv)
        outs, lses = [], []
        for m, l, o in state:
            outs.append(o / torch.clamp(l, min=1e-30)[..., None])
            lses.append(m + torch.log(l))
        out32 = torch.stack(outs, dim=1)                  # [B,n,KV,G,c,D]
        out32 = out32.permute(0, 1, 4, 2, 3, 5).reshape(b, s_local, h, d)
        ctx.ring = r
        ctx.save_for_backward(q, k, v, out32, torch.stack(lses, dim=1))
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out32, lse = ctx.saved_tensors
        r = ctx.ring
        b, s_local, h, d = r.shape
        q32 = r.grouped(q) * r.scale
        do32 = r.grouped(do)
        # delta = rowsum(dO * O) per query row, [B, n, KV, G, c]
        delta = (do32 * r.grouped(out32)).sum(dim=-1).permute(0, 1, 3, 4, 2)
        dq = torch.zeros_like(q32)
        # K, V and their fp32 gradient accumulators travel together
        carry = torch.cat([torch.stack([k, v]).float(),
                           torch.zeros((2,) + tuple(k.shape),
                                       device=k.device)])
        for t in range(r.ring):
            for i, j, mask in r.tiles(t):
                kb, vb = r.block(carry[0], j), r.block(carry[1], j)
                s = r.scores(q32[:, i], kb, mask)
                p = torch.exp(s - lse[:, i][..., None])
                if mask is not None:
                    p = torch.where(mask, p, 0.0)
                do_i = do32[:, i]
                dp = torch.einsum("bqkgd,bskd->bkgqs", do_i, vb)
                ds = p * (dp - delta[:, i][..., None])
                dq[:, i] += torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
                sl = slice(j * r.c, (j + 1) * r.c)
                carry[2][:, sl] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                                q32[:, i])
                carry[3][:, sl] += torch.einsum("bkgqs,bqkgd->bskd", p,
                                                do_i)
            # the last hop takes only the gradients home
            carry = r.hop(carry if t < r.ring - 1 else carry[2:])
        grads = carry[-2:]
        dq = (dq * r.scale).reshape(b, s_local, h, d).to(q.dtype)
        return (dq, grads[0].to(k.dtype), grads[1].to(v.dtype), None, None,
                None, None, None)
