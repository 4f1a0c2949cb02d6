"""Dense grouped-query attention (port of ``dcos_commons_tpu/ops/attention.py``).

Layout is [B, S, H, D]. Softmax is fp32; inputs and output ride in the
caller's dtype. This is the paged prefill-chunk attention and the oracle
the decode kernel is held against.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_NEG = -1e30

IntOrTensor = Union[int, torch.Tensor]


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] by head-group broadcast."""
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  sm_scale: Optional[float] = None,
                  q_offset: IntOrTensor = 0,
                  kv_len: Optional[IntOrTensor] = None) -> torch.Tensor:
    """Attention with K/V head broadcast for GQA.

    q: [B, Sq, H, D]; k/v: [B, Sk, KV, D] with H % KV == 0.
    ``q_offset`` shifts query positions: a scalar applies to every row,
    a [B] vector per row. ``kv_len`` masks cache slots >= kv_len: a
    scalar for every row, a [B] vector per row.
    """
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s_q, s_k = scores.shape[-2], scores.shape[-1]
    dev = q.device
    k_idx = torch.arange(s_k, dtype=torch.int32, device=dev)
    mask = None
    if causal:
        off = torch.as_tensor(q_offset, dtype=torch.int32, device=dev)
        # [B|1, Sq, 1]: a scalar offset reduces to the shared causal mask
        q_pos = (off.reshape(-1, 1, 1)
                 + torch.arange(s_q, dtype=torch.int32,
                                device=dev)[None, :, None])
        mask = (q_pos >= k_idx[None, None, :])[:, None]
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, dtype=torch.int32,
                              device=dev).reshape(-1, 1, 1, 1)
        valid = k_idx[None, None, None, :] < kvl
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)
