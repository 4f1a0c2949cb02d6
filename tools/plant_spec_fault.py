#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's speculative
decoding, to show that the checks catch it.

    python3 tools/plant_spec_fault.py s1|s2|s3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one change:

* s1: the spec window's ``n_emit`` counts one accepted token too many
  (``models/serving.py``);
* s2: ``PagedServer.reset`` reallocates the draft cache, which the
  captured spec graphs keep reading and writing (``models/serving.py``);
* s3: the verify's causal ``q_offset`` is off by one, so each window
  query also sees the next window token (``models/llama.py``).

Then run ``python3 chip_smoke.py`` and the card tests from DEST; each
fault must fail both. Raises if the text a fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import SERVING, plant  # noqa: E402

FAULTS = {
    "s1": (SERVING, "agree.sum(dim=1).to(torch.int32) + 1,",
           "agree.sum(dim=1).to(torch.int32) + 2,"),
    "s2": (SERVING, "            _zero_(self._draft_cache)\n",
           "            cfg_d = self._draft[0]\n"
           "            self._draft_cache = llama.init_kv_cache(\n"
           "                cfg_d, self.slots, cfg_d.max_seq,\n"
           "                device=self.device)\n"),
    "s3": ("dcos_commons_tpu_torch/models/llama.py",
           "causal=True,\n                             q_offset=lengths, "
           "kv_len=lengths + kk)",
           "causal=True,\n                             q_offset=lengths + 1, "
           "kv_len=lengths + kk)"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
