"""Loss heads (port of ``dcos_commons_tpu/ops/losses.py``): fp32
reductions, optional z-loss.

* :func:`softmax_cross_entropy` consumes materialized logits [..., V];
  plain autograd.
* :func:`fused_linear_cross_entropy` fuses the lm_head projection into
  the loss: the sequence is cut into blocks, each block's logits are
  projected, reduced to per-token logsumexp and NLL, and dropped. Its
  ``torch.autograd.Function`` backward recomputes each block's logits
  from the saved per-token logsumexp, so the [B, S, V] fp32 logits never
  exist in either direction; peak scratch is one [B, block, V] tile.

Block products are ``torch.matmul`` on operands of the head's dtype. An
fp32 head computes exactly the reference's fp32 products. A bf16 head
puts bf16 operands on the tensor cores with fp32 accumulation, which is
the precision of the reference's default-precision dot on a TPU (the MXU
rounds fp32 operands to bf16); a full fp32 product of [B*block, V] x
[V, D] would cost more than the rest of the train step. Distillation
(``fused_linear_distillation``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .quant import QArray, QTensor, qmm


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0,
                          compute_accuracy: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mean token cross-entropy over logits [..., V] and int labels
    [...]: (loss, accuracy), accuracy None unless ``compute_accuracy``.
    ``z_loss`` adds ``z_loss * logz**2`` per token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - true_logit
    if z_loss:
        nll = nll + z_loss * logz ** 2
    correct = ((logits.argmax(-1) == labels).float()
               if compute_accuracy else None)
    if mask is not None:
        m = mask.float()
        denom = torch.clamp(m.sum(), min=1.0)
        return ((nll * m).sum() / denom,
                (correct * m).sum() / denom if compute_accuracy else None)
    return nll.mean(), correct.mean() if compute_accuracy else None


def _block_logits(xb: torch.Tensor, w: QArray) -> torch.Tensor:
    """One block's logits [B, blk, V] in fp32 (``qmm`` in the activations'
    dtype, then widened, as the reference)."""
    return qmm(xb, w).float()


def _dx_block(dlog: torch.Tensor, w: QArray, dtype: torch.dtype
              ) -> torch.Tensor:
    """dlogits [B, blk, V] -> dx [B, blk, D]. Quantized: ``W.T ==
    q.T * s_row``, so scale the cotangent per vocab column and multiply
    the int8 payload (no dequantized [D, V] copy), in fp32."""
    if isinstance(w, QTensor):
        srow = w.s.squeeze(-2).float()                          # [V]
        return ((dlog * srow) @ w.q.float().t()).to(dtype)
    return (dlog.to(w.dtype) @ w.t()).to(dtype)


class _FusedLCE(torch.autograd.Function):
    """(x [B, S, D], head [D, V] or QTensor, labels [B, S], maskf [B, S])
    -> (loss, accuracy); S is a multiple of ``block``."""

    @staticmethod
    def forward(ctx, x, w, labels, maskf, z_loss, block, compute_acc):
        b, s, _ = x.shape
        nll_sum = x.new_zeros((), dtype=torch.float32)
        cor_sum = x.new_zeros((), dtype=torch.float32)
        logz = x.new_empty((b, s), dtype=torch.float32)
        for s0 in range(0, s, block):
            sl = slice(s0, s0 + block)
            logits = _block_logits(x[:, sl], w)                  # [B, blk, V]
            lz = torch.logsumexp(logits, dim=-1)                 # [B, blk]
            lb, mb = labels[:, sl], maskf[:, sl]
            nll = lz - torch.gather(logits, -1, lb[..., None])[..., 0]
            if z_loss:
                nll = nll + z_loss * lz ** 2
            nll_sum += (nll * mb).sum()
            if compute_acc:
                cor_sum += ((logits.argmax(-1) == lb).float() * mb).sum()
            logz[:, sl] = lz
            del logits
        denom = torch.clamp(maskf.sum(), min=1.0)
        acc = cor_sum / denom
        ctx.mark_non_differentiable(acc)
        if isinstance(w, QTensor):
            ctx.save_for_backward(x, labels, maskf, logz, denom)
            ctx.qhead = w
        else:
            ctx.save_for_backward(x, labels, maskf, logz, denom, w)
            ctx.qhead = None
        ctx.z_loss, ctx.block = z_loss, block
        return nll_sum / denom, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        """Per token, dlogits = ``p * (1 + 2 z logz) - onehot``, scaled
        by ``g * mask / denom``. The accuracy output has no gradient;
        a quantized head gets none either (its scales are frozen)."""
        x, labels, maskf, logz, denom = ctx.saved_tensors[:5]
        w = ctx.qhead if ctx.qhead is not None else ctx.saved_tensors[5]
        plain_w = ctx.qhead is None
        z_loss, block = ctx.z_loss, ctx.block
        scale = (g_loss / denom).float()
        dx = torch.empty_like(x)
        dw = (torch.zeros(w.shape, dtype=torch.float32, device=x.device)
              if plain_w and ctx.needs_input_grad[1] else None)
        for s0 in range(0, x.shape[1], block):
            sl = slice(s0, s0 + block)
            xb, lz = x[:, sl], logz[:, sl]
            dlog = torch.exp_(_block_logits(xb, w) - lz[..., None])
            if z_loss:
                dlog *= (1.0 + (2.0 * z_loss) * lz)[..., None]
            dlog.scatter_add_(-1, labels[:, sl, None],
                              dlog.new_full(labels[:, sl, None].shape, -1.0))
            dlog *= (scale * maskf[:, sl])[..., None]            # [B, blk, V]
            dx[:, sl] = _dx_block(dlog, w, x.dtype)
            if dw is not None:
                d = xb.shape[-1]
                dw += (xb.reshape(-1, d).t().to(w.dtype)
                       @ dlog.reshape(-1, dlog.shape[-1]).to(w.dtype)).float()
            del dlog
        return (dx, dw.to(w.dtype) if dw is not None else None, None, None,
                None, None, None)


def fused_linear_cross_entropy(x: torch.Tensor, lm_head: QArray,
                               labels: torch.Tensor, *,
                               mask: Optional[torch.Tensor] = None,
                               z_loss: float = 0.0, block_size: int = 512,
                               compute_accuracy: bool = True
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Cross-entropy of ``x @ lm_head`` without materializing the logits.

    ``x`` [..., S, D] (final-norm hidden states), ``lm_head`` [D, V] (a
    tensor or an int8 :class:`~dcos_commons_tpu_torch.ops.quant.QTensor`),
    ``labels`` [..., S] ints. Same result as
    ``softmax_cross_entropy(qmm(x, lm_head).float(), labels, ...)``:
    masked mean NLL (+ z-loss) and argmax accuracy, computed in
    ``block_size`` sequence chunks. ``S % block_size != 0`` is padded
    under the mask. Differentiable in ``x`` and a plain ``lm_head``; the
    mask and a quantized head get no gradient.
    """
    lead = x.shape[:-2]
    s, d = x.shape[-2], x.shape[-1]
    b = 1
    for n in lead:
        b *= n
    xf = x.reshape(b, s, d)
    lab = labels.reshape(b, s).long()
    maskf = (torch.ones((b, s), dtype=torch.float32, device=x.device)
             if mask is None else mask.reshape(b, s).float())
    block = max(1, min(int(block_size), s))
    pad = -s % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        lab = torch.nn.functional.pad(lab, (0, pad))
        maskf = torch.nn.functional.pad(maskf, (0, pad))  # pads never count
    loss, acc = _FusedLCE.apply(xf.contiguous(), lm_head, lab, maskf,
                                float(z_loss), block, bool(compute_accuracy))
    return loss, (acc if compute_accuracy else None)
