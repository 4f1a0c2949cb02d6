#!/usr/bin/env python3
"""Phase 15a's checks of ``chip_smoke.py``, each on its own, on the CPU
at a tiny width, in the tree this is run from (for a copy with a planted
fault of ``tools/plant_tp_fault.py``: which checks catch it).

    cd DEST && python3 /path/to/tools/torch_tp_checks.py

A gang of two gloo ranks (``chip_smoke.tp_rank`` on the CPU) serves 6 of
phase 3's requests through ``PagedServer(mesh=)``, and those of them in
``TP_SLOT_REQUESTS`` through ``SlotServer(mesh=)``, in bf16 and in fp32; prints one ``RESULT`` JSON line: whether every
rank's streams equal rank 0's, whether the near-tie rule (each bf16
stream teacher-forced through the one-process weights) passes, and
whether the fp32 streams equal the one-process engines'."""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from dcos_commons_tpu_torch.models import llama, serving  # noqa: E402
from dcos_commons_tpu_torch.parallel.distributed import launch_local  # noqa: E402,E501

KW = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
          ffn_dim=512, max_seq=2048)


def main() -> int:
    cfg = llama.LlamaConfig.llama3_8b(**KW)
    params = llama.init_params(cfg, torch.Generator().manual_seed(c.SEED),
                               device="cpu")
    queue = c.serve_queue(cfg.vocab_size)[:6]
    solo = serving.PagedServer(cfg, params, slots=8, page_size=64,
                               prefill_chunk=64, device="cpu").drain(
        [dict(r) for r in queue], decode_window=8)
    ranks = launch_local(c.tp_rank, 2, queue, c.TP_SLOT_REQUESTS, KW, 2, 1,
                         "cpu", timeout_s=900)
    out = {"ranks_equal": all(
        r[n][k] == ranks[0][n][k] for r in ranks
        for n in ("paged", "slots") for k in ("streams", "fp32_streams"))}
    prompts = {q["request_id"]: q["prompt"] for q in queue}
    for n in ("paged", "slots"):
        want = {i: t for i, t in solo.items()
                if n == "paged" or i in c.TP_SLOT_REQUESTS}
        try:
            c.stream_check(n, ranks[0][n]["streams"], want, prompts, cfg,
                           params)
            out[f"near_tie_{n}"] = "pass"
        except RuntimeError:
            out[f"near_tie_{n}"] = "caught"
    want = c.tp_fp32_reference(queue, c.TP_SLOT_REQUESTS, KW, 2,
                               torch.device("cpu"))
    for n in ("paged", "slots"):
        out[f"fp32_{n}"] = ("pass" if ranks[0][n]["fp32_streams"] == want[n]
                            else "caught")
    print("RESULT", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
