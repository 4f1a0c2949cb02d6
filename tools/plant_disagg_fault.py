#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's
disaggregated serving, to show that the checks catch it.

    python3 tools/plant_disagg_fault.py d1|d2|d3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) whose ``dcos_commons_tpu_torch/models/serving.py`` carries one
change:

* d1: ``adopt_pages`` installs into a NEW pool (a copy of the old one)
  and rebinds ``self.pool``, so the captured windows keep reading the
  old tensors;
* d2: an adoption that fails after its reservation re-raises without
  giving the references back;
* d3: ``prefill_span`` gathers each of the stream's pages one page off.

Then run the CPU tests, ``python3 chip_smoke.py`` (or its phase 12) and
the card tests from DEST. Raises if the text a fault changes is not
found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import SERVING, plant  # noqa: E402

FAULTS = {
    "d1": (SERVING, "                self._install(payload, matched, "
                    "span_pages,\n",
           "                self.pool = {\n"
           "                    side: (QTensor(p.q.clone(), p.s.clone())\n"
           "                           if isinstance(p, QTensor)\n"
           "                           else p.clone())\n"
           "                    for side, p in self.pool.items()}\n"
           "                self._install(payload, matched, span_pages,\n"),
    "d2": (SERVING, "            # an aborted transfer: every reservation "
                    "unwinds\n"
                    "            for p in shared:\n"
                    "                self.ledger.unref(p)\n"
                    "            for p in pages:\n"
                    "                self.ledger.unref(p)\n"
                    "            raise\n",
           "            raise\n"),
    "d3": (SERVING, "        payload = self._gather_span(stream_pages)\n",
           "        payload = self._gather_span([p + 1 for p in "
           "stream_pages])\n"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
