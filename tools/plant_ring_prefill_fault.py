#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's ring
prefill, to show that the checks catch it.

    python3 tools/plant_ring_prefill_fault.py r1|r2|r3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one fault:

* r1: the K/V gather in reversed rank order (``PagedServer._ring_prefill``
  in ``dcos_commons_tpu_torch/models/serving.py``): the ranks' shards
  land in the pages back to front;
* r2: a rank's rope positions start at 0 (``prefill_ring`` in
  ``dcos_commons_tpu_torch/models/llama.py``): every rank rotates its
  shard as if it began the sequence;
* r3: the pad pages written over a live page rather than the scratch
  page (``PagedServer._ring_prefill``): the pages of the padding past a
  prompt's last page point at that last page, so their K/V lands on it.

Then run the CPU tests (``tests/test_torch_ring_prefill.py``) and phase
20 of ``chip_smoke.py`` (``phase_ring_serve``, ``phase_ring_worker``)
from DEST. Raises if the text a fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

SERVING = "dcos_commons_tpu_torch/models/serving.py"
LLAMA = "dcos_commons_tpu_torch/models/llama.py"

FAULTS = {
    "r1": (SERVING,
           "            kv = kv.reshape(2, cfg.n_layers, n_pages, ps, "
           "*kv.shape[3:])\n",
           "            kv = torch.cat(kv.chunk(sp, dim=2)[::-1], dim=2)\n"
           "            kv = kv.reshape(2, cfg.n_layers, n_pages, ps, "
           "*kv.shape[3:])\n"),
    "r2": (LLAMA, "rope = _rope_table(cfg, rope, prompt.device)[:, at:at + n]",
           "rope = _rope_table(cfg, rope, prompt.device)[:, :n]"),
    "r3": (SERVING, "phys = np.full((n_pages,), self.scratch, np.int64)",
           "phys = np.full((n_pages,), self._tables[slot][own - 1], "
           "np.int64)"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
