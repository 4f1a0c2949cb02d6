"""Speculative decoding (port of ``dcos_commons_tpu/models/speculative.py``):
a draft model proposes, the target verifies K tokens per weight pass,
with greedy exact-match or sampled rejection acceptance.

* :func:`rejection_step`: one position of speculative rejection sampling
  (numpy, as in the reference).
* :class:`SpeculativeDecoder`: batch-1 speculative decoding over two slot
  caches: the draft's ``decode_chunk`` proposes, the target's
  ``extend_step`` verifies. ``generate`` is greedy (``temperature`` 0, acceptance
  on the device) or sampled; ``generate_fused`` is the same greedy
  stream under the reference's one-program name. The numpy RNG is seeded and drawn as the reference's, so a
  sampled run with no draft step (``k`` 1) gives the reference's stream;
  the draft's own samples come from a ``torch.Generator`` seeded from
  that RNG (the reference's come from a JAX key), so sampled proposals
  differ from the reference's.
* The sealed draft artifact: :func:`save_draft` writes the draft's
  sharded parameters (``parallel.checkpoint``) and ``draft_config.json``
  with the blake2s of their manifest; :func:`load_draft` runs every
  check that can fail before the weights reach an engine and raises
  :class:`DraftIncompatible` with the reference's codes.
* Training a draft (the worker's ``distill``): :func:`draft_student`
  copies the target's first layers, :func:`distill_loss` is the step's
  loss against the frozen target through the fused linear-KL head.

Execution differs from the reference only mechanically: the jitted
draft chunk, verify and fused ``while_loop`` are eager loops, and the
caches are updated in place.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.rotary import rope_frequencies
from ..ops.sampling import make_sampler
from . import llama

Params = llama.Params


def _softmax(logits: np.ndarray) -> np.ndarray:
    x = logits.astype(np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def rejection_step(p: np.ndarray, q: np.ndarray, x: int,
                   rng: np.random.Generator) -> Tuple[int, bool]:
    """One position of speculative rejection sampling.

    ``p``/``q``: target/draft probability rows over the vocab; ``x``:
    the draft's proposal (sampled from ``q``). Returns (token,
    accepted): accept w.p. min(1, p(x)/q(x)), else resample from the
    residual normalize(max(p - q, 0)), so the emitted token's marginal is
    exactly ``p``."""
    if rng.random() < min(1.0, float(p[x]) / max(float(q[x]), 1e-30)):
        return int(x), True
    resid = np.maximum(p - q, 0.0)
    total = resid.sum()
    probs = p if total <= 0.0 else resid / total
    return int(rng.choice(len(probs), p=probs)), False


class SpeculativeDecoder:
    """Speculative decoding for batch-1 serving. ``temperature == 0``
    (default) is greedy exact-match acceptance; ``temperature > 0`` is
    sampled rejection acceptance over the tempered distributions. Both
    parameter trees must live on ``device``."""

    def __init__(self, cfg_t: llama.LlamaConfig, params_t: Params,
                 cfg_d: llama.LlamaConfig, params_d: Params, k: int = 4,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = "cuda"):
        if cfg_t.vocab_size != cfg_d.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.device = resolve_device(device)
        llama.check_params_device(params_t, self.device, "decoder")
        llama.check_params_device(params_d, self.device, "decoder")
        self.cfg_t, self.params_t = cfg_t, params_t
        self.cfg_d, self.params_d = cfg_d, params_d
        self.k = k
        self.temperature = temperature
        self._rng = np.random.default_rng(seed)
        self._rope_t = rope_frequencies(cfg_t.head_dim, cfg_t.max_seq,
                                        cfg_t.rope_theta, device=self.device)
        self._rope_d = rope_frequencies(cfg_d.head_dim, cfg_d.max_seq,
                                        cfg_d.rope_theta, device=self.device)
        self._sampler = (make_sampler(temperature) if temperature > 0.0
                         else None)

    def _check(self, prompt: torch.Tensor, steps: int) -> int:
        b, s = prompt.shape
        if b != 1:
            raise ValueError("speculative decoding is batch-1")
        need = s + steps + self.k
        if need > self.cfg_t.max_seq or need > self.cfg_d.max_seq:
            raise ValueError(
                f"prompt {s} + steps {steps} + k {self.k} exceeds "
                f"max_seq (target {self.cfg_t.max_seq}, draft "
                f"{self.cfg_d.max_seq})")
        return s

    def _prefill(self, prompt: torch.Tensor):
        """Both caches prefilled with the prompt: (target logits [1, V],
        target cache, draft cache)."""
        cache_t = llama.init_kv_cache(self.cfg_t, 1, self.cfg_t.max_seq,
                                      device=self.device)
        cache_d = llama.init_kv_cache(self.cfg_d, 1, self.cfg_d.max_seq,
                                      device=self.device)
        lt, cache_t = llama.prefill(self.cfg_t, self.params_t, cache_t,
                                    prompt, rope=self._rope_t)
        _, cache_d = llama.prefill(self.cfg_d, self.params_d, cache_d,
                                   prompt, rope=self._rope_d)
        return lt, cache_t, cache_d

    def _greedy(self, prompt: torch.Tensor, steps: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The greedy stream with acceptance on the device. Each pass
        decodes k draft steps, verifies the window in one target forward,
        counts the agreeing prefix with a cumulative product and writes
        the window's target tokens into a fixed [steps + k] buffer at the
        emission count; the host reads only the pass's emission count
        (the next position) and the final buffer."""
        s = self._check(prompt, steps)
        k = self.k
        lt, cache_t, cache_d = self._prefill(prompt)
        cur = torch.argmax(lt, dim=-1).to(torch.int32)             # [1]
        out = torch.zeros((steps + k,), dtype=torch.int32,
                          device=self.device)
        out[0] = cur[0]
        n_out, pos, passes = 1, s, 0
        while n_out < steps:
            if k > 1:
                dtoks, cache_d = llama.decode_chunk(
                    self.cfg_d, self.params_d, cache_d, pos, cur, k,
                    rope=self._rope_d)
                prop = dtoks[0, :k - 1]
            else:
                prop = cur[:0]
            window = torch.cat([cur, prop])[None, :]
            logits, cache_t = llama.extend_step(
                self.cfg_t, self.params_t, cache_t, window, pos,
                rope=self._rope_t)
            tgt = torch.argmax(logits[0], dim=-1).to(torch.int32)   # [k]
            agree = torch.cumprod((prop == tgt[:k - 1]).to(torch.int32),
                                  dim=0)
            n_emit = agree.sum() + 1                                 # 1..k
            out[n_out:n_out + k] = tgt
            cur = tgt[n_emit - 1][None]
            n = int(n_emit)
            n_out += n
            pos += n
            passes += 1
        proposed = passes * (k - 1)
        accepted = n_out - 1 - passes
        stats = {"verify_passes": passes,
                 "tokens_per_pass": round(steps / max(passes, 1), 3),
                 "proposed": proposed, "accepted": accepted,
                 "accept_rate": round(accepted / max(proposed, 1), 4),
                 "temperature": 0.0, "k": k}
        return out[None, :steps].cpu(), stats

    def generate_fused(self, prompt: torch.Tensor, steps: int
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The reference's one-program greedy loop: :meth:`generate`'s
        greedy stream, with its guards and its ``fused`` stats key."""
        if self.temperature > 0.0:
            raise ValueError("generate_fused is greedy-only; sampled "
                             "acceptance uses generate()")
        if self.k < 2:
            raise ValueError("generate_fused needs k >= 2")
        toks, stats = self._greedy(prompt, steps)
        stats["fused"] = True
        return toks, stats

    def generate(self, prompt: torch.Tensor, steps: int
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Decode ``steps`` tokens; returns (tokens [1, steps] on the
        host, stats). Greedy mode emits the target's greedy stream;
        sampled mode emits tokens whose marginal is the target's tempered
        distribution."""
        temp = self.temperature
        if temp == 0.0:
            self._rng.integers(2 ** 31)    # drawn as the reference's key
            return self._greedy(prompt, steps)
        s = self._check(prompt, steps)
        lt, cache_t, cache_d = self._prefill(prompt)
        p0 = _softmax(lt[0].float().cpu().numpy() / temp)
        cur = int(self._rng.choice(len(p0), p=p0))
        out = [cur]
        pos = s                       # next write position (holds `cur`)
        passes = proposed = accepted = 0
        gen = torch.Generator(device=self.device).manual_seed(
            int(self._rng.integers(2 ** 31)))
        while len(out) < steps:
            draft_toks, draft_logits = [], None
            cur_t = torch.tensor([cur], dtype=torch.int32,
                                 device=self.device)
            if self.k > 1:
                dtoks, dlogits, cache_d = llama.decode_chunk_logits(
                    self.cfg_d, self.params_d, cache_d, pos, cur_t, self.k,
                    rope=self._rope_d, sampler=self._sampler,
                    generator=gen)
                draft_toks = dtoks[0].tolist()[:self.k - 1]
                draft_logits = dlogits[0].float().cpu().numpy()[
                    :self.k - 1]
            window = torch.tensor([[cur] + draft_toks], dtype=torch.int32,
                                  device=self.device)
            logits, cache_t = llama.extend_step(
                self.cfg_t, self.params_t, cache_t, window, pos,
                rope=self._rope_t)
            passes += 1
            proposed += len(draft_toks)
            # replacement and bonus tokens land at the next pass's write
            # position as `cur`, so both caches stay consistent
            p = _softmax(logits[0].float().cpu().numpy() / temp)
            emitted = []
            for i, x in enumerate(draft_toks):
                q = _softmax(draft_logits[i] / temp)
                tok, ok = rejection_step(p[i], q, x, self._rng)
                emitted.append(tok)
                if not ok:
                    break
                accepted += 1
            else:
                # the whole window accepted: a bonus token from the
                # target's distribution after the last proposal
                emitted.append(int(self._rng.choice(
                    p.shape[1], p=p[len(draft_toks)])))
            pos += len(emitted)
            cur = emitted[-1]
            out.extend(emitted)
        out = out[:steps]
        stats = {"verify_passes": passes,
                 "tokens_per_pass": round(len(out) / max(passes, 1), 3),
                 "proposed": proposed, "accepted": accepted,
                 "accept_rate": round(accepted / max(proposed, 1), 4),
                 "temperature": temp, "k": self.k}
        return torch.tensor([out], dtype=torch.int32), stats

# ---------------------------------------------------------------------------
# draft artifacts: a trained draft as a loadable, compat-guarded unit


class DraftIncompatible(ValueError):
    """A draft the serving engine must not arm, with a stable ``code``
    (the reference's):

    * ``draft_config_missing``: no ``draft_config.json`` beside the
      shards;
    * ``draft_manifest_stale``: the shard manifest no longer matches what
      :func:`save_draft` sealed (overwritten, truncated or bit-rotted), or
      the shards failed their restore;
    * ``draft_vocab_mismatch`` / ``draft_rope_mismatch`` /
      ``draft_max_seq``: the draft cannot speak for this target;
    * ``draft_sampled_engine`` / ``draft_k``: arm-time refusals
      (:meth:`~dcos_commons_tpu_torch.models.serving.PagedServer.
      arm_draft`).

    Serving catches it and keeps decoding solo."""

    def __init__(self, code: str, msg: str):
        super().__init__(f"{code}: {msg}")
        self.code = code


_DRAFT_CFG_FIELDS = ("vocab_size", "dim", "n_layers", "n_heads",
                     "n_kv_heads", "ffn_dim", "max_seq", "rope_theta",
                     "norm_eps")


def _manifest_digest(step_dir: str) -> str:
    with open(os.path.join(step_dir, "manifest.json"), "rb") as f:
        return hashlib.blake2s(f.read()).hexdigest()


def save_draft(out_dir: str, step: int, cfg_d: llama.LlamaConfig,
               params_d: Params,
               target_cfg: Optional[llama.LlamaConfig] = None) -> str:
    """Persist a draft as a self-describing artifact: sharded parameters
    (the reference's checkpoint format) plus ``draft_config.json`` with
    the draft's architecture, the target it speaks for and the blake2s of
    the shard manifest, the seal :func:`load_draft` verifies. Returns the
    committed step directory."""
    from ..parallel.checkpoint import save_sharded
    step_dir = save_sharded(out_dir, step, {"params": params_d})
    meta = {
        "config": {f: getattr(cfg_d, f) for f in _DRAFT_CFG_FIELDS},
        "step": step,
        "manifest_digest": _manifest_digest(step_dir),
        "target": (None if target_cfg is None else
                   {"vocab_size": target_cfg.vocab_size,
                    "rope_theta": target_cfg.rope_theta,
                    "max_seq": target_cfg.max_seq,
                    "n_layers": target_cfg.n_layers,
                    "dim": target_cfg.dim}),
    }
    tmp = os.path.join(out_dir, ".draft_config.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(out_dir, "draft_config.json"))
    return step_dir


def draft_student(cfg_t: llama.LlamaConfig, params_t: Params, layers: int
                  ) -> Tuple[llama.LlamaConfig, Params]:
    """``(cfg_d, params_d)``: the target's first ``layers`` layers with
    the embedding, final norm and head, every leaf a copy. The cut
    (:func:`llama.truncate_layers`) is a view, and the train step updates
    in place: without the copies the optimizer would write into the
    target."""
    cfg_d, params_d = llama.truncate_layers(cfg_t, params_t, layers)
    return cfg_d, {k: ({n: w.clone() for n, w in v.items()}
                       if isinstance(v, dict) else v.clone())
                   for k, v in params_d.items()}


def distill_loss(cfg_t: llama.LlamaConfig, params_t: Params,
                 cfg_d: llama.LlamaConfig, temperature: float):
    """The distill step's ``loss_fn(params_d, tokens) -> (loss, loss)``:
    the frozen target's final hidden states (under ``torch.no_grad``) and
    the student's, into the fused linear-KL head
    (``ops.losses.fused_linear_distillation``). Each part runs under a
    ``distill.*`` profiler range."""
    from torch.profiler import record_function

    from ..ops.losses import fused_linear_distillation

    def loss_fn(p_d, batch):
        with torch.no_grad(), record_function("distill.teacher_forward"):
            x_t = llama.forward(cfg_t, params_t, batch, return_hidden=True)
        with record_function("distill.student_forward"):
            x_s = llama.forward(cfg_d, p_d, batch, return_hidden=True)
        with record_function("distill.kl_head"):
            loss = fused_linear_distillation(
                x_s, p_d["lm_head"], x_t, params_t["lm_head"],
                temperature=temperature)
        return loss, loss

    return loss_fn


def load_draft(path: str, cfg_t: Optional[llama.LlamaConfig] = None,
               device: DeviceLike = "cuda"
               ) -> Tuple[llama.LlamaConfig, Params, Dict[str, Any]]:
    """Load a :func:`save_draft` artifact onto ``device``, running every
    check that can fail before the weights reach an engine, in the
    reference's order: the config sidecar exists; with ``cfg_t``, the
    draft shares its vocabulary and rope and covers its positions; the
    sealed step is the newest committed one; the manifest hashes to the
    sealed digest; every shard restores against the manifest's digests.
    Raises :class:`DraftIncompatible` with a stable code on any failure;
    returns ``(cfg_d, params_d, meta)``."""
    from ..parallel.checkpoint import (CheckpointCorrupt, _process_id,
                                       latest_step, restore_sharded)
    cfg_path = os.path.join(path, "draft_config.json")
    if not os.path.exists(cfg_path):
        raise DraftIncompatible(
            "draft_config_missing",
            f"no draft_config.json under {path!r}: not a draft artifact")
    with open(cfg_path, encoding="utf-8") as f:
        meta = json.load(f)
    cfg_d = llama.LlamaConfig(**meta["config"])
    if cfg_t is not None:
        if cfg_d.vocab_size != cfg_t.vocab_size:
            raise DraftIncompatible(
                "draft_vocab_mismatch",
                f"draft vocab {cfg_d.vocab_size} != target "
                f"{cfg_t.vocab_size}")
        if cfg_d.rope_theta != cfg_t.rope_theta:
            raise DraftIncompatible(
                "draft_rope_mismatch",
                f"draft rope_theta {cfg_d.rope_theta} != target "
                f"{cfg_t.rope_theta}")
        if cfg_d.max_seq < cfg_t.max_seq:
            raise DraftIncompatible(
                "draft_max_seq",
                f"draft max_seq {cfg_d.max_seq} < target "
                f"{cfg_t.max_seq}")
    step = meta.get("step")
    if step is None or latest_step(path) != step:
        raise DraftIncompatible(
            "draft_manifest_stale",
            f"recorded step {step} is not the newest committed step "
            f"under {path!r}: the artifact was overwritten after "
            "save_draft sealed it")
    step_dir = os.path.join(path, f"step-{step:08d}-p{_process_id()}")
    try:
        digest = _manifest_digest(step_dir)
    except OSError:
        raise DraftIncompatible(
            "draft_manifest_stale",
            f"shard manifest unreadable under {step_dir!r}") from None
    if digest != meta.get("manifest_digest"):
        raise DraftIncompatible(
            "draft_manifest_stale",
            "shard manifest digest does not match draft_config.json: "
            "the checkpoint changed after save_draft sealed it")
    template = {"params": llama.param_template(cfg_d, device)}
    try:
        tree = restore_sharded(path, template, step)
    except (CheckpointCorrupt, FileNotFoundError) as e:
        raise DraftIncompatible(
            "draft_manifest_stale",
            f"draft shards failed restore: {e}") from None
    return cfg_d, tree["params"], meta
