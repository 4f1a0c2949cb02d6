"""Token sampling: temperature, top-k, nucleus (port of
``dcos_commons_tpu/ops/sampling.py``).

The masks match the reference's. Random draws come from a
``torch.Generator`` (Gumbel-max over the surviving logits), so a sampled
stream cannot reproduce a JAX key's; greedy decoding (``make_sampler``
returns None) is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

# sample(generator, logits [B, V]) -> tokens [B]
Sampler = Callable[[Optional[torch.Generator], torch.Tensor], torch.Tensor]

_NEG_INF = float("-inf")


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, -inf elsewhere (ties at the
    threshold all survive)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the
    probability-sorted vocabulary whose mass reaches ``p``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    # mass strictly BEFORE each position: position 0 is always kept
    before = torch.cumsum(probs, dim=-1) - probs
    cut = (before < p).sum(dim=-1, keepdim=True)           # tokens kept
    threshold = torch.gather(sorted_logits, -1, cut - 1)
    return torch.where(logits < threshold, _NEG_INF, logits)


@dataclasses.dataclass(frozen=True)
class ConfiguredSampler:
    """A sampler that compares by its settings."""

    temperature: float
    top_k: int
    top_p: float

    def __call__(self, generator: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
        # temperature first: nucleus membership is decided on the
        # tempered distribution; top-k is order-insensitive
        x = logits.float() / self.temperature
        if self.top_k:
            x = top_k_mask(x, self.top_k)
        if 0.0 < self.top_p < 1.0:
            x = top_p_mask(x, self.top_p)
        # Gumbel-max: -log(E) with E ~ Exp(1) is Gumbel(0, 1)
        e = torch.empty_like(x).exponential_(generator=generator)
        return torch.argmax(x - torch.log(e), dim=-1)


def make_sampler(temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0) -> Optional[Sampler]:
    """Build a sampler, or ``None`` for greedy (temperature 0)."""
    if temperature == 0.0:
        return None
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    return ConfiguredSampler(temperature, top_k, top_p)
