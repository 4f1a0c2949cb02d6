#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's KV tiers, to
show that the checks catch it.

    python3 tools/plant_tier_fault.py t1|t2|t3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) whose ``dcos_commons_tpu_torch/models/serving.py`` carries one
change:

* t1: ``_promote_from_tier`` installs into a NEW pool (a copy of the old
  one) and rebinds ``self.pool``, so the captured windows keep reading
  the old tensors;
* t2: ``_release`` inserts a retiring stream's pages into the radix
  without ``_radix_adopt``: the re-acquired chains keep their tier
  frames (two owners) and are never published;
* t3: ``_demote`` gathers the page after the victim.

Then run the CPU tests, ``python3 chip_smoke.py`` (or its phase 11) and
the card tests from DEST. Raises if the text a fault changes is not
found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import SERVING, plant  # noqa: E402

FAULTS = {
    "t1": (SERVING, "        self._install(payload, 0, m,\n",
           "        self.pool = {side: (QTensor(p.q.clone(), p.s.clone())\n"
           "                            if isinstance(p, QTensor)\n"
           "                            else p.clone())\n"
           "                     for side, p in self.pool.items()}\n"
           "        self._install(payload, 0, m,\n"),
    "t2": (SERVING, "            self._radix_adopt(prompt, pages)\n",
           "            self.radix.insert(prompt, pages)\n"),
    "t3": (SERVING, '"payload": self._gather_span([page])})',
           '"payload": self._gather_span([page + 1])})'),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
