#!/usr/bin/env python3
"""How far the MoE paged engine's bf16 streams leave the stepwise
reference on the GPU, and why: routing decisions that two valid bf16
computations take differently.

    python3 tools/torch_moe_routing.py

Builds the MoE model of ``chip_smoke.py`` phase 10 (Llama-3-8B widths
and depth, 8 experts top-2, dropless; random bf16 weights from seed 0),
drains phase 3's 12 requests through ``PagedServer(moe=...)`` and prints
three JSON lines:

* ``teacher``: each stream teacher-forced through the reference's own
  path (the prompt in one ``extend_step``, then one ``decode_step`` a
  token): per stream the first token that is not the reference's argmax
  (with the logit gap there), over all tokens the share within
  ``chip_smoke.NEAR_TIE_ATOL`` of the top logit, the gaps above it, and
  the router margin of each step (the smallest gap between the 2nd and
  3rd router logits over the layers, the top-2 boundary);
* ``prefill_routing``: the longest prompt (1,500 tokens) prefilled in the
  engine's 64-token chunks and in one ``extend_step``: the router
  logits' difference by layer and the top-2 decisions that differ;
* ``fp32_parity``: ``chip_smoke._moe_fp32_parity``, the engine against
  ``generate_stepwise_moe`` in fp32 at reduced depth.

Needs a CUDA device (about 70 GB); imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _recorder(cfg, moe, store, rows="last"):
    """``make_moe_ffn``'s FFN, recording each layer's fp32 router logits
    (of the call's last row, or of every row) into ``store``."""
    from dcos_commons_tpu_torch.models import llama
    from dcos_commons_tpu_torch.ops.norms import rms_norm
    base = llama.make_moe_ffn(cfg, moe)

    def ffn(x, lp):
        b, s, d = x.shape
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        z = h.reshape(b * s, d).float() @ lp["router"].float()
        store.append(z if rows == "all" else z[-1:])
        return base(x, lp)

    return ffn


def _margin(z):
    """Distance of the top-2 decision from a flip: 2nd less 3rd logit."""
    import torch
    top = torch.topk(z, 3, dim=-1).values
    return top[..., 1] - top[..., 2]


def _teacher(cfg, moe, params, prompt, toks):
    """Teacher-force ``toks`` through the stepwise reference's path:
    [(gap, router margin, the reference's argmax)] a token."""
    import torch
    from dcos_commons_tpu_torch.models import llama
    dev = params["norm"].device
    store = []
    ffn = _recorder(cfg, moe, store)
    rope = llama._rope_table(cfg, None, dev)
    cache = llama.init_kv_cache(cfg, 1, cfg.max_seq, device=dev)
    logits, _ = llama.extend_step(
        cfg, params, cache, torch.tensor([prompt], dtype=torch.int32,
                                         device=dev), 0, rope=rope,
        ffn_override=ffn)
    logits = logits[:, -1]
    out = []
    for j, t in enumerate(toks):
        margin = float(_margin(torch.cat(store)).min())
        store.clear()
        out.append((float(logits.max() - logits[0, t]), margin,
                    int(logits.argmax())))
        logits, _ = llama.decode_step(
            cfg, params, cache, len(prompt) + j,
            torch.tensor([t], dtype=torch.int32, device=dev), rope=rope,
            ffn_override=ffn)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_routing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from dcos_commons_tpu_torch.models import llama, serving
    from dcos_commons_tpu_torch.parallel.moe import MoEConfig, dropless

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    moe = dropless(MoEConfig(c.MOE_EXPERTS))
    cfg = llama.LlamaConfig.llama3_8b(max_seq=2048)
    params = llama.init_moe_params(
        cfg, c.MOE_EXPERTS, torch.Generator(device=dev).manual_seed(c.SEED),
        device=dev)
    srv = serving.PagedServer(cfg, params, slots=8, page_size=64,
                              prefill_chunk=64, moe=moe, device=dev)
    srv.warmup()
    queue = c.serve_queue(cfg.vocab_size)
    c.drain_timed(srv, queue)

    rows, first = [], {}
    for r in queue:
        got = srv.finished[r["request_id"]]
        row = _teacher(cfg, moe, params, r["prompt"], got)
        rows += row
        j = next((i for i, (_, _, a) in enumerate(row) if a != got[i]), None)
        first[r["request_id"]] = (None if j is None else
                                  {"at": j, "gap": row[j][0],
                                   "margin": row[j][1]})
    gaps = np.array([g for g, _, _ in rows])
    margins = np.array([m for _, m, _ in rows])
    atol = c.NEAR_TIE_ATOL
    print(json.dumps({"teacher": {
        "tokens": len(rows), "near_tie_atol": atol,
        "near_tie_share": float((gaps <= atol).mean()),
        "argmax_share": float((gaps == 0).mean()),
        "max_gap": float(gaps.max()),
        "away": sorted((round(float(g), 4), round(float(m), 5))
                       for g, m, _ in rows if g > atol),
        "first_divergence": first,
        "step_margin_quantiles": dict(zip(
            ("p01", "p05", "p10", "p25", "p50"),
            np.quantile(margins, [0.01, 0.05, 0.1, 0.25, 0.5]).tolist())),
        "card": card}}), flush=True)

    prompt = max((r["prompt"] for r in queue), key=len)
    whole = []
    rope = llama._rope_table(cfg, None, dev)
    cache = llama.init_kv_cache(cfg, 1, cfg.max_seq, device=dev)
    llama.extend_step(cfg, params, cache,
                      torch.tensor([prompt], dtype=torch.int32, device=dev),
                      0, rope=rope,
                      ffn_override=_recorder(cfg, moe, whole, "all"))
    del cache
    srv.reset()
    chunked = []
    srv._ffn = _recorder(cfg, moe, chunked, "all")
    srv.submit(prompt, max_new=1)
    while srv._prefill_q:
        srv._prefill_tick()
    nl, n = cfg.n_layers, len(prompt)
    zc = torch.stack([torch.cat(chunked[i::nl])[:n] for i in range(nl)])
    zw = torch.stack(whole)                                  # [L, n, E]
    dz = (zc - zw).abs()
    pick = lambda z: torch.topk(z, 2, -1).indices.sort(-1).values  # noqa
    flips = (pick(zc) != pick(zw)).any(-1)                   # [L, n]
    first_layer = torch.where(flips.any(0), flips.float().argmax(0),
                              torch.full((n,), -1, device=dev))
    print(json.dumps({"prefill_routing": {
        "prompt": n, "chunk": srv.prefill_chunk,
        "router_logit_diff_median": float(dz.median()),
        "router_logit_diff_max_by_layer": dz.amax((1, 2)).tolist(),
        "decisions_differ": int(flips.sum()), "decisions": nl * n,
        "tokens_with_a_differing_decision": int(flips.any(0).sum()),
        "first_differing_layer_quantiles": np.quantile(
            first_layer[first_layer >= 0].cpu().numpy(),
            [0.1, 0.5, 0.9]).tolist() if bool(flips.any()) else None,
        "card": card}}), flush=True)
    del srv, params, zc, zw, dz
    torch.cuda.empty_cache()
    print(json.dumps({"fp32_parity": {**c._moe_fp32_parity(queue),
                                      "card": card}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
