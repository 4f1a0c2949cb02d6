#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's CUDA-graph
decode windows, to show that the checks catch it.

    python3 tools/plant_graph_fault.py g1|g2|g3 DEST

DEST receives a copy of the tree (without ``.git/`` and the top-level
directories ``.gitignore`` lists) whose
``dcos_commons_tpu_torch/models/serving.py``
carries one change:

* g1: a window does not copy its lengths back (the graph replays every
  window from the lengths it started with);
* g2: ``PagedServer`` keys its graphs by the window size alone, not by
  the table width (a wider window replays a narrower table's graph);
* g3: ``PagedServer.reset`` reallocates the pool (the captured graphs
  keep writing the old one).

Then run ``python3 chip_smoke.py`` and the card tests from DEST; each
fault must fail both. Raises if the text a fault changes is not found.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVING = "dcos_commons_tpu_torch/models/serving.py"

# fault -> (file, text, replacement)
FAULTS = {
    "g1": (SERVING, "        self.lengths.copy_(ln)\n", ""),
    "g2": (SERVING, "self._run_window((k, mp), active,",
           "self._run_window(k, active,"),
    "g3": (SERVING, "        _zero_(self.pool)\n",
           "        self.pool = llama.init_page_pool(\n"
           "            self.cfg, self.total_pages + 1, self.page_size,\n"
           "            device=self.device)\n"),
}


def plant(faults, doc: str, argv) -> int:
    """Copy the tree to ``argv[1]`` with fault ``argv[0]`` of ``faults``
    planted."""
    if len(argv) != 2 or argv[0] not in faults:
        print(doc, file=sys.stderr)
        return 2
    target, old, new = faults[argv[0]]
    dest = Path(argv[1]).resolve()
    if dest.exists():
        shutil.rmtree(dest)
    skip = {".git"} | {
        line.strip().strip("/") for line in
        (ROOT / ".gitignore").read_text().splitlines()
        if line.strip().endswith("/") and "*" not in line}
    shutil.copytree(ROOT, dest, ignore=lambda d, names: [
        n for n in names if Path(d) == ROOT and n in skip
        or n == "__pycache__"])
    path = dest / target
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{argv[0]}: the text to change occurs "
                         f"{text.count(old)} times in {target}")
    path.write_text(text.replace(old, new))
    print(f"{argv[0]} planted in {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
