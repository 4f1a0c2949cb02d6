#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's live
migration or fleet router, to show that the checks catch it.

    python3 tools/plant_migrate_fault.py m1|m2|m3|r1 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one change:

* m1: ``PagedServer.import_stream`` writes the stream's length into a
  NEW ``lengths`` tensor (a copy of the old one) and rebinds it, so the
  captured windows keep reading the old one;
* m2: ``PagedServer.export_stream`` ships ``kv_len`` one position short
  (one page fewer when the last written position starts a page);
* m3: ``MigrationManager.migrate_stream`` releases the victim's copy
  before the destination's adoption commits;
* r1: ``router.route_key`` hashes one full page too few.

Then run the CPU tests, ``python3 chip_smoke.py`` (or its phase 13) and
the card tests from DEST. Raises if the text a fault changes is not
found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import SERVING, plant  # noqa: E402

MIGRATE = "dcos_commons_tpu_torch/models/migrate.py"
ROUTER = "dcos_commons_tpu_torch/models/router.py"

FAULTS = {
    "m1": (SERVING, "        self.lengths[slot] = kv_len\n",
           "        self.lengths = self.lengths.clone()\n"
           "        self.lengths[slot] = kv_len\n"),
    "m2": (SERVING, "        kv_len = n + len(r.tokens) - 1\n"
                    "        pages = self._stream_pages[slot]",
           "        kv_len = n + len(r.tokens) - 2\n"
           "        pages = self._stream_pages[slot]"),
    "m3": (MIGRATE, "            try:\n"
                    "                # the in-process hop round-trips",
           "            victim.release_stream(slot)\n"
           "            try:\n"
           "                # the in-process hop round-trips"),
    "r1": (ROUTER, "page_hashes(prompt, page_size)[:max(1, affinity_pages)]",
           "page_hashes(prompt, page_size)[:max(1, affinity_pages) - 1]"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
