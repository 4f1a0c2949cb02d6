"""ResNet (port of ``dcos_commons_tpu/models/resnet.py``): the
data-parallel north-star workload (BASELINE.json config #4, the
``resnet`` service), on one device or on a ``dp`` process mesh.

The reference's choices are kept where they decide the numbers: bf16
weights and activations, fp32 batch-norm statistics, and a functional
``(params, state)`` split in which the batch-norm running statistics
are a separate tree that the step returns anew (no gradient, no weight
decay). Parameters keep the reference's keys, shapes and dtypes: conv
weights HWIO ``[kh, kw, cin, cout]``, the head ``[cin, n_classes]``, so a
checkpoint of either package restores in the other.

Layout. ``x`` arrives as ``[B, H, W, 3]``. Inside, activations are NCHW
tensors in ``torch.channels_last`` memory, which is the reference's
physical NHWC; the weights are permuted to OIHW (channels-last) at use
and autograd takes their gradients back to HWIO. Convolutions are
``F.conv2d`` (cuDNN on the card).

Three places where plain PyTorch idiom gives other numbers:

* SAME padding is XLA's: ``(total // 2, total - total // 2)``, which is
  asymmetric for a strided 7x7 or 3x3 conv and for the 3x3/s2 max-pool on
  even sizes. :func:`same_pads` computes it from the size, kernel and
  stride; an asymmetric pad goes through ``F.pad`` (``-inf`` for the
  pool) before an unpadded conv or pool.
* Batch norm is the reference's fused form, not ``F.batch_norm``: the
  mean and the mean of squares in fp32 from the bf16 input, the biased
  variance ``max(E[x^2] - E[x]^2, 0)``, the EMA at ``bn_momentum`` on
  that variance, then one multiply-add in ``x.dtype`` with
  ``a = scale * rsqrt(var + eps)`` and ``b = bias - mean * a``. Gradients
  flow through the batch statistics. In eval mode the running statistics
  are used and the state comes back unchanged.
* On a mesh (``mesh=`` with ``dp > 1``) each rank holds an equal share
  of the global batch, and in training each batch norm's fp32 mean and
  mean of squares are averaged over ``dp`` (one all-reduce-mean of the
  two, ``Mesh.all_reduce_mean``, whose backward averages the
  cotangents) before the variance and the running-state update: the
  statistics, the loss and the gradients are the reference's over the
  global batch, and every rank holds the same state. A forward issues
  one collective a batch norm (53 at depth 50) and its backward as many;
  evaluation issues none.
* Rounding points: each conv returns ``x.dtype``, the residual add and
  the relu run in it, and the global average pool rounds to it once
  before the fp32 head.

``stem_s2d`` (off by default) runs the 7x7/s2 stem as a 4x4/s1 conv over
2x2-folded input: the same sums, in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.losses import softmax_cross_entropy

Params = Dict[str, Any]
BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
          101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK = {50, 101, 152}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    n_classes: int = 1000
    width: int = 64
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    stem_s2d: bool = False

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return BLOCKS[self.depth]

    @property
    def bottleneck(self) -> bool:
        return self.depth in BOTTLENECK


def _block_convs(cfg: ResNetConfig, cin: int, width: int, cout: int,
                 stride: int):
    """(kh, kw, cin, cout, stride) of a block's convs, in key order."""
    if cfg.bottleneck:
        return [(1, 1, cin, width, 1), (3, 3, width, width, stride),
                (1, 1, width, cout, 1)]
    return [(3, 3, cin, width, stride), (3, 3, width, cout, 1)]


def _blocks(cfg: ResNetConfig):
    """(name, cin, width, cout, stride, has_proj) of every block."""
    cin = cfg.width
    expansion = 4 if cfg.bottleneck else 1
    for stage, n_blocks in enumerate(cfg.stage_blocks):
        width = cfg.width * (2 ** stage)
        cout = width * expansion
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            yield (f"stage{stage}_block{b}", cin, width, cout, stride,
                   b == 0 and (cin != cout or stride != 1))
            cin = cout


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Tuple[Params, Params]:
    """``(params, bn_state)``: He-scaled normal conv weights (fp32 draws
    cast to ``cfg.dtype``), batch-norm scale 1 and bias 0 in fp32, running
    mean 0 and variance 1, a ``cin ** -0.5``-scaled head and a zero fp32
    head bias. ``generator`` must live on ``device``. Torch and JAX draw
    different numbers from one seed: parity tests carry the JAX trees
    over with ``models.bridge.resnet_from_jax``."""
    dev = resolve_device(device)

    def conv(kh, kw, ci, co):
        w = torch.randn((kh, kw, ci, co), generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * (2.0 / (kh * kw * ci)) ** 0.5).to(cfg.dtype)

    def bn(c):
        return {"scale": torch.ones((c,), device=dev),
                "bias": torch.zeros((c,), device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros((c,), device=dev),
                "var": torch.ones((c,), device=dev)}

    p: Params = {"stem": {"conv": conv(7, 7, 3, cfg.width),
                          "bn": bn(cfg.width)}}
    s: Params = {"stem": {"bn": bn_state(cfg.width)}}
    cin = cfg.width
    for name, cin, width, cout, stride, proj in _blocks(cfg):
        bp: Params = {}
        bs: Params = {}
        for i, (kh, kw, ci, co, _) in enumerate(
                _block_convs(cfg, cin, width, cout, stride)):
            bp[f"conv{i}"] = conv(kh, kw, ci, co)
            bp[f"bn{i}"] = bn(co)
            bs[f"bn{i}"] = bn_state(co)
        if proj:
            bp["proj"] = conv(1, 1, cin, cout)
            bp["proj_bn"] = bn(cout)
            bs["proj_bn"] = bn_state(cout)
        p[name], s[name] = bp, bs
        cin = cout
    head = torch.randn((cin, cfg.n_classes), generator=generator,
                       device=dev, dtype=torch.float32)
    p["head"] = {"w": (head * cin ** -0.5).to(cfg.dtype),
                 "b": torch.zeros((cfg.n_classes,), device=dev)}
    return p, s


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ``(before, after)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int) -> Tuple[int, int, int, int]:
    """``F.pad`` order (left, right, top, bottom) for an NCHW tensor."""
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    return left, right, top, bottom


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """An HWIO weight as the OIHW channels-last tensor ``F.conv2d`` takes
    beside channels-last activations (a copy; autograd maps it back)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv_padded(x, w, stride, pads):
    """``F.conv2d`` with explicit (left, right, top, bottom) pads."""
    left, right, top, bottom = pads
    if left == right and top == bottom:
        return F.conv2d(x, _oihw(w), stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, pads), _oihw(w), stride=stride)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with an HWIO weight."""
    return _conv_padded(x, w, stride, _pads(x, w.shape[0], stride))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """The 3x3/s2 SAME max-pool (``-inf`` padding)."""
    pads = _pads(x, 3, 2)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _stem_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2 SAME stem as a 4x4/s1 conv over 2x2-folded input (even
    H and W): SAME pads (2, 3), so output i taps rows 2i-2..2i+4, blocks
    i-1..i+2 of 2x2-block space: a 4-block window padded (1, 2), with the
    kernel zero-padded to 8 rows and columns before folding."""
    b, c, h, w_ = x.shape
    xs = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w_ // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w_ // 2, 4 * c)
    xs = xs.permute(0, 3, 1, 2)
    w8 = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    cin, cout = w.shape[2], w.shape[3]
    wf = w8.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    wf = wf.reshape(4, 4, 4 * cin, cout)
    return _conv_padded(xs, wf, 1, (1, 2, 1, 2))


class _MeanSquare(torch.autograd.Function):
    """Per-channel mean of ``x.float() ** 2`` over (N, H, W). Autograd of
    the plain expression would keep the fp32 copy of ``x`` for the
    backward; this keeps ``x`` itself."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.float().square().mean(dim=(0, 2, 3))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        return (x.float() * (2.0 * g / n)[None, :, None, None]).to(x.dtype)


def _batch_norm(x: torch.Tensor, bn: Params, st: Params, cfg: ResNetConfig,
                train: bool, mesh=None) -> Tuple[torch.Tensor, Params]:
    """The reference's fused-apply batch norm over NCHW ``x``: fp32
    statistics (over the global batch on a dp mesh), then one
    multiply-add in ``x.dtype``."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3), dtype=torch.float32)
        mean_sq = _MeanSquare.apply(x)
        if mesh is not None and mesh.shape["dp"] > 1:
            mean, mean_sq = mesh.all_reduce_mean(
                torch.stack([mean, mean_sq]), "dp").unbind(0)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        m = cfg.bn_momentum
        new_st = {"mean": m * st["mean"] + (1 - m) * mean,
                  "var": m * st["var"] + (1 - m) * var}
    else:
        mean, var = st["mean"], st["var"]
        new_st = st
    a = bn["scale"] * torch.rsqrt(var + cfg.bn_eps)
    b = bn["bias"] - mean * a
    return (torch.addcmul(b.to(x.dtype)[None, :, None, None], x,
                          a.to(x.dtype)[None, :, None, None]), new_st)


def forward(cfg: ResNetConfig, params: Params, state: Params,
            x: torch.Tensor, train: bool = True, mesh=None
            ) -> Tuple[torch.Tensor, Params]:
    """x [B, H, W, 3] -> (logits [B, n_classes] fp32, new bn_state).
    ``x`` is this rank's share of the global batch on a dp ``mesh``."""
    # the NHWC input viewed as NCHW is channels-last already
    x = x.to(cfg.dtype).permute(0, 3, 1, 2)
    new_state: Params = {}
    if cfg.stem_s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
        x = _stem_s2d(x, params["stem"]["conv"])
    else:
        x = _conv(x, params["stem"]["conv"], stride=2)
    x, st = _batch_norm(x, params["stem"]["bn"], state["stem"]["bn"], cfg,
                        train, mesh)
    new_state["stem"] = {"bn": st}
    x = _max_pool(torch.relu(x))
    n_convs = 3 if cfg.bottleneck else 2
    # the strided conv: the 3x3 of a bottleneck, the first of a basic block
    strided = 1 if cfg.bottleneck else 0
    for name, _, _, _, stride, _ in _blocks(cfg):
        bp, bs = params[name], state[name]
        ns: Params = {}
        shortcut = y = x
        for i in range(n_convs):
            y = _conv(y, bp[f"conv{i}"], stride if i == strided else 1)
            y, ns[f"bn{i}"] = _batch_norm(y, bp[f"bn{i}"], bs[f"bn{i}"],
                                          cfg, train, mesh)
            if i < n_convs - 1:
                y = torch.relu(y)
        if "proj" in bp:
            shortcut = _conv(shortcut, bp["proj"], stride)
            shortcut, ns["proj_bn"] = _batch_norm(
                shortcut, bp["proj_bn"], bs["proj_bn"], cfg, train, mesh)
        x = torch.relu(y + shortcut)
        new_state[name] = ns
    x = x.mean(dim=(2, 3)).float()                    # global avg pool
    logits = x @ params["head"]["w"].float() + params["head"]["b"]
    return logits, new_state


def loss_fn(cfg: ResNetConfig, params: Params, state: Params,
            batch: Tuple[torch.Tensor, torch.Tensor], mesh=None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, Params]]:
    """``(loss, (accuracy, new bn_state))`` of ``batch = (x, labels)``, in
    train mode; on a dp ``mesh`` the loss and accuracy are this rank's
    (the train step averages them) and the state is the global batch's."""
    x, y = batch
    logits, new_state = forward(cfg, params, state, x, train=True,
                                mesh=mesh)
    loss, acc = softmax_cross_entropy(logits, y)
    return loss, (acc, new_state)
