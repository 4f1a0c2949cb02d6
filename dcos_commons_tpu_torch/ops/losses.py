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
  With ``mesh=`` (tensor parallelism, the head sharded ``(None, "tp")``)
  it is vocabulary-parallel: each rank projects its V/tp columns, and a
  block's logsumexp, target logit and argmax come from two collectives
  (``Mesh.all_reduce_max`` of the local maxima, then one sum of the
  local sums of exponentials, target logits and lower tied columns); the
  backward gives the rank's head shard its own columns' gradient and sums
  the hidden states' partial gradients over ``tp`` ("f" on ``x``).

Block products are ``torch.matmul`` on operands of the head's dtype. An
fp32 head computes exactly the reference's fp32 products. A bf16 head
puts bf16 operands on the tensor cores with fp32 accumulation, which is
the precision of the reference's default-precision dot on a TPU (the MXU
rounds fp32 operands to bf16); a full fp32 product of [B*block, V] x
[V, D] would cost more than the rest of the train step.

* :func:`softmax_kl_divergence` is the distillation loss on materialized
  logits (plain autograd), the reference the fused head is held to.
* :func:`fused_linear_distillation` fuses both heads into the KL loss
  the same way: each sequence block projects the student's and the
  teacher's hidden states to fp32 logits tiles, reduces them to the
  per-token KL and the two logsumexp rows (the only residuals), and drops
  them; the backward recomputes both tiles. Gradients reach the student's
  hidden states and a plain student head only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.profiler import record_function

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
        dx, dw = _lce_backward(ctx, g_loss, 0)
        return dx, dw, None, None, None, None, None


def _lce_backward(ctx, g_loss, first: int):
    """(dx, dw) of the fused loss over the head's columns, which hold the
    vocabulary's ids ``first, first + 1, ...``: per token, dlogits =
    ``p * (1 + 2 z logz) - onehot`` (the onehot's -1 only where the label
    is one of them), scaled by ``g * mask / denom``. The accuracy output
    has no gradient; a quantized head gets none either (its scales are
    frozen)."""
    x, labels, maskf, logz, denom = ctx.saved_tensors[:5]
    w = ctx.qhead if ctx.qhead is not None else ctx.saved_tensors[5]
    z_loss, block, cols = ctx.z_loss, ctx.block, w.shape[-1]
    scale = (g_loss / denom).float()
    dx = torch.empty_like(x)
    dw = (torch.zeros(w.shape, dtype=torch.float32, device=x.device)
          if ctx.qhead is None and ctx.needs_input_grad[1] else None)
    for s0 in range(0, x.shape[1], block):
        sl = slice(s0, s0 + block)
        xb, lz = x[:, sl], logz[:, sl]
        dlog = torch.exp_(_block_logits(xb, w) - lz[..., None])
        if z_loss:
            dlog *= (1.0 + (2.0 * z_loss) * lz)[..., None]
        local = labels[:, sl] - first
        inside = (local >= 0) & (local < cols)
        dlog.scatter_add_(-1, local.clamp(0, cols - 1)[..., None],
                          -inside[..., None].to(dlog.dtype))
        dlog *= (scale * maskf[:, sl])[..., None]            # [B, blk, cols]
        dx[:, sl] = _dx_block(dlog, w, x.dtype)
        if dw is not None:
            d = xb.shape[-1]
            dw += (xb.reshape(-1, d).t().to(w.dtype)
                   @ dlog.reshape(-1, dlog.shape[-1]).to(w.dtype)).float()
        del dlog
    return dx, dw.to(w.dtype) if dw is not None else None


class _FusedLCETP(torch.autograd.Function):
    """:class:`_FusedLCE` over a vocabulary sharded on ``tp``: ``w`` is
    the rank's [D, V/tp] columns, ``labels`` are global ids, and every
    rank returns the same loss and accuracy."""

    @staticmethod
    def forward(ctx, x, w, labels, maskf, z_loss, block, compute_acc, mesh):
        b, s, _ = x.shape
        cols = w.shape[-1]
        first = mesh.coords["tp"] * cols                    # global id of col 0
        ids = torch.arange(first, first + cols, device=x.device)
        nll_sum = x.new_zeros((), dtype=torch.float32)
        cor_sum = x.new_zeros((), dtype=torch.float32)
        logz = x.new_empty((b, s), dtype=torch.float32)
        for s0 in range(0, s, block):
            sl = slice(s0, s0 + block)
            logits = _block_logits(x[:, sl], w)          # [B, blk, V/tp]
            top = mesh.all_reduce_max(logits.amax(dim=-1))          # [B, blk]
            lb, mb = labels[:, sl], maskf[:, sl]
            local = lb - first
            inside = (local >= 0) & (local < cols)
            target = torch.where(inside, torch.gather(
                logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0],
                torch.zeros_like(top))
            parts = [torch.exp(logits - top[..., None]).sum(dim=-1), target]
            if compute_acc:
                # the columns tied with the top logit below the label: the
                # label is the argmax (lowest id among ties, as jnp's) iff
                # its logit is the top and there are none
                parts.append(((logits == top[..., None])
                              & (ids < lb[..., None])).sum(dim=-1).float())
            sums = mesh.all_reduce(torch.stack(parts), "tp")
            lz = top + torch.log(sums[0])
            nll = lz - sums[1]
            if z_loss:
                nll = nll + z_loss * lz ** 2
            nll_sum += (nll * mb).sum()
            if compute_acc:
                cor_sum += (((sums[1] == top) & (sums[2] == 0)).float()
                            * mb).sum()
            logz[:, sl] = lz
            del logits
        denom = torch.clamp(maskf.sum(), min=1.0)
        acc = cor_sum / denom
        ctx.mark_non_differentiable(acc)
        ctx.qhead = w if isinstance(w, QTensor) else None
        ctx.save_for_backward(x, labels, maskf, logz, denom,
                              *(() if isinstance(w, QTensor) else (w,)))
        ctx.z_loss, ctx.block, ctx.mesh, ctx.first = (z_loss, block, mesh,
                                                      first)
        return nll_sum / denom, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        """:func:`_lce_backward` on the rank's columns; dx is the sum of
        the ranks' partial products over ``tp``."""
        dx, dw = _lce_backward(ctx, g_loss, ctx.first)
        return (ctx.mesh.all_reduce(dx, "tp"), dw, None, None, None, None,
                None, None)


def fused_linear_cross_entropy(x: torch.Tensor, lm_head: QArray,
                               labels: torch.Tensor, *,
                               mask: Optional[torch.Tensor] = None,
                               z_loss: float = 0.0, block_size: int = 512,
                               compute_accuracy: bool = True,
                               mesh=None
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

    ``mesh`` (a ``parallel.mesh.Mesh`` whose ``tp`` is > 1): ``lm_head``
    is this rank's [D, V/tp] columns and the loss vocabulary-parallel
    (module doc); ``x`` is the whole hidden state on every rank.
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
    args = (xf.contiguous(), lm_head, lab, maskf, float(z_loss), block,
            bool(compute_accuracy))
    if mesh is not None and mesh.shape["tp"] > 1:
        loss, acc = _FusedLCETP.apply(*args, mesh)
    else:
        loss, acc = _FusedLCE.apply(*args)
    return loss, (acc if compute_accuracy else None)


# ---------------------------------------------------------------------------
# fused linear + KL distillation (neither logits tensor materialized)


def softmax_kl_divergence(logits_s: torch.Tensor, logits_t: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          temperature: float = 1.0) -> torch.Tensor:
    """Masked mean per-token ``KL(softmax(logits_t/T) ||
    softmax(logits_s/T))`` on materialized logits [..., V], in fp32."""
    inv = 1.0 / temperature
    zs = logits_s.float() * inv
    zt = logits_t.float() * inv
    lzs = torch.logsumexp(zs, dim=-1)
    lzt = torch.logsumexp(zt, dim=-1)
    pt = torch.exp(zt - lzt[..., None])
    kl = (lzs - lzt) + ((zt - zs) * pt).sum(dim=-1)
    if mask is not None:
        m = mask.float()
        return (kl * m).sum() / torch.clamp(m.sum(), min=1.0)
    return kl.mean()


def _tempered_logits(xb: torch.Tensor, w: QArray, inv: float
                     ) -> torch.Tensor:
    """One block's fp32 logits tile [B, blk, V], divided by T in place."""
    z = _block_logits(xb, w)
    if inv != 1.0:
        z *= inv
    return z


def _softmax_(z: torch.Tensor, lz: torch.Tensor) -> torch.Tensor:
    """``exp(z - lz)`` written over the tile ``z``."""
    return z.sub_(lz[..., None]).exp_()


class _FusedKL(torch.autograd.Function):
    """(x_s [B, S, Ds], head_s [Ds, V] or QTensor, x_t [B, S, Dt], head_t,
    maskf [B, S]) -> loss; S is a multiple of ``block``. At most three
    fp32 tiles of one block are live in either direction (the two logits
    tiles and one temporary), each overwritten in place."""

    @staticmethod
    def forward(ctx, xs, ws, xt, wt, maskf, temp, block):
        b, s, _ = xs.shape
        inv = 1.0 / temp
        kl_sum = xs.new_zeros((), dtype=torch.float32)
        lzs = xs.new_empty((b, s), dtype=torch.float32)
        lzt = xs.new_empty((b, s), dtype=torch.float32)
        for s0 in range(0, s, block):
            sl = slice(s0, s0 + block)
            zs = _tempered_logits(xs[:, sl], ws, inv)            # [B, blk, V]
            lzs_b = torch.logsumexp(zs, dim=-1)
            zt = _tempered_logits(xt[:, sl], wt, inv)
            lzt_b = torch.logsumexp(zt, dim=-1)
            d = zs.neg_().add_(zt)                               # zt - zs
            pt = _softmax_(zt, lzt_b)
            kl = (lzs_b - lzt_b) + d.mul_(pt).sum(dim=-1)
            kl_sum += (kl * maskf[:, sl]).sum()
            lzs[:, sl], lzt[:, sl] = lzs_b, lzt_b
            del zs, zt, d, pt
        denom = torch.clamp(maskf.sum(), min=1.0)
        ctx.heads = (ws if isinstance(ws, QTensor) else None,
                     wt if isinstance(wt, QTensor) else None)
        ctx.save_for_backward(
            xs, xt, maskf, lzs, lzt, denom,
            *(w for w in (ws, wt) if not isinstance(w, QTensor)))
        ctx.temp, ctx.block = temp, block
        return kl_sum / denom

    @staticmethod
    def backward(ctx, g):
        """Per token, dlogits_s = ``(p_s - p_t) * g * mask / (denom *
        T)``. The teacher side and a quantized student head get no
        gradient."""
        xs, xt, maskf, lzs, lzt, denom, *plain = ctx.saved_tensors
        q_s, q_t = ctx.heads
        ws = q_s if q_s is not None else plain.pop(0)
        wt = q_t if q_t is not None else plain.pop(0)
        inv = 1.0 / ctx.temp
        block = ctx.block
        scale = (g / denom).float() * inv
        want_dx = ctx.needs_input_grad[0]
        want_dw = q_s is None and ctx.needs_input_grad[1]
        dx = torch.empty_like(xs) if want_dx else None
        dw = (torch.zeros(ws.shape, dtype=torch.float32, device=xs.device)
              if want_dw else None)
        with record_function("fused_kl.backward"):
            for s0 in range(0, xs.shape[1], block):
                sl = slice(s0, s0 + block)
                xb = xs[:, sl]
                dlog = _softmax_(_tempered_logits(xb, ws, inv), lzs[:, sl])
                pt = _softmax_(_tempered_logits(xt[:, sl], wt, inv),
                               lzt[:, sl])
                dlog.sub_(pt).mul_((scale * maskf[:, sl])[..., None])
                del pt
                if q_s is not None:
                    if want_dx:
                        dx[:, sl] = _dx_block(dlog, ws, xs.dtype)
                    del dlog
                    continue
                dlog = dlog.to(ws.dtype)           # one copy for both products
                if want_dx:
                    dx[:, sl] = (dlog @ ws.t()).to(xs.dtype)
                if want_dw:
                    d = xb.shape[-1]
                    dw += (xb.reshape(-1, d).t().to(ws.dtype)
                           @ dlog.reshape(-1, dlog.shape[-1])).float()
                del dlog
        return (dx, dw.to(ws.dtype) if dw is not None else None,
                None, None, None, None, None)


def fused_linear_distillation(x_s: torch.Tensor, head_s: QArray,
                              x_t: torch.Tensor, head_t: QArray, *,
                              mask: Optional[torch.Tensor] = None,
                              temperature: float = 1.0,
                              block_size: int = 512) -> torch.Tensor:
    """KL(teacher || student) of ``x_s @ head_s`` vs ``x_t @ head_t``
    without materializing either logits tensor.

    ``x_s`` / ``x_t`` [..., S, Ds] / [..., S, Dt] (final-norm hidden
    states; the widths may differ, the vocabularies must match),
    ``head_s`` / ``head_t`` [D, V] (tensors or int8
    :class:`~dcos_commons_tpu_torch.ops.quant.QTensor`). Same value as
    ``softmax_kl_divergence(qmm(x_s, head_s), qmm(x_t, head_t), ...)``,
    computed in ``block_size`` sequence chunks (``S % block_size != 0``
    is padded under the mask). ``temperature`` tempers both
    distributions; the gradients carry its 1/T. Differentiable in ``x_s``
    and a plain ``head_s`` only: the teacher side gets no gradient, with
    or without a ``torch.no_grad`` teacher forward.
    """
    if x_s.shape[:-1] != x_t.shape[:-1]:
        raise ValueError(f"student/teacher token shapes differ: "
                         f"{tuple(x_s.shape[:-1])} vs "
                         f"{tuple(x_t.shape[:-1])}")
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    s = x_s.shape[-2]
    b = x_s[..., 0, 0].numel()
    xs = x_s.reshape(b, s, x_s.shape[-1])
    xt = x_t.reshape(b, s, x_t.shape[-1])
    maskf = (torch.ones((b, s), dtype=torch.float32, device=x_s.device)
             if mask is None else mask.reshape(b, s).float())
    block = max(1, min(int(block_size), s))
    pad = -s % block
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        xt = torch.nn.functional.pad(xt, (0, 0, 0, pad))
        maskf = torch.nn.functional.pad(maskf, (0, pad))  # pads never count
    return _FusedKL.apply(xs.contiguous(), head_s, xt.contiguous(), head_t,
                          maskf, float(temperature), block)
