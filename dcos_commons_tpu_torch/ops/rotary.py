"""Rotary position embeddings (port of ``dcos_commons_tpu/ops/rotary.py``).

JAX clamps an out-of-range gather index silently; torch raises on the
CPU and asserts on the device. The reference's per-position lookups
(``table[0][pos]``) rely on that clamp when a stream that retired
mid-window keeps advancing past ``max_seq - 1``, so the lookups here
clamp explicitly to the table, which gives the reference's values.
"""

from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """Stacked [2, max_seq, head_dim//2] fp32 (cos, sin) table."""
    dev = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv)                         # [S, D/2]
    return torch.stack([torch.cos(freqs), torch.sin(freqs)])


def _lookup(table: torch.Tensor, pos: torch.Tensor):
    pos = pos.long().clamp(0, table.shape[1] - 1)
    return table[0][pos], table[1][pos]


def apply_rope(x: torch.Tensor, table: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    """Rotate [B, S, H, D] by positions ``offset..offset+S`` (the full-
    sequence path of the train forward). As the reference's
    ``lax.dynamic_slice``, a window that would run off the table keeps its
    length and moves its START back to fit (clamped to
    ``[0, max_seq - S]``); a window longer than the table raises."""
    seq, n = x.shape[1], table.shape[1]
    if seq > n:
        raise ValueError(f"apply_rope: {seq} positions exceed the rope "
                         f"table's {n}")
    start = min(max(int(offset), 0), n - seq)
    cos = table[0, start:start + seq][None, :, None, :]
    sin = table[1, start:start + seq][None, :, None, :]
    return _rotate(x, cos, sin, x.shape[-1] // 2)


def apply_rope_positions(x: torch.Tensor, table: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Rotate [B, S, H, D] at explicit positions ``pos`` [S] shared by
    every batch row: the chunked-prefill path, where a resumed chunk's
    window may overrun the table (its tail past ``true_len`` is dead
    padding). Per-lane lookup, so only the dead tail lanes saturate."""
    cos, sin = _lookup(table, pos)
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :],
                   x.shape[-1] // 2)


def apply_rope_at(x: torch.Tensor, table: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Rotate a single decode position PER STREAM: x [B, 1, H, D], pos
    [B] (each batch row at its own sequence position)."""
    cos, sin = _lookup(table, pos)
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :],
                   x.shape[-1] // 2)


def apply_rope_at_many(x: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """Rotate a K-token window PER STREAM: x [B, K, H, D], pos [B, K]
    (each stream's window at its own positions: the paged speculative
    verify). Lookups clamp to the table, as every lookup here does."""
    cos, sin = _lookup(table, pos)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :],
                   x.shape[-1] // 2)


def _rotate(x, cos, sin, half):
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
