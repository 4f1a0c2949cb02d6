#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's tensor
parallelism, to show that the checks catch it.

    python3 tools/plant_tp_fault.py p1|p2|p3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) whose ``dcos_commons_tpu_torch/models/llama.py`` carries one
fault:

* p1: the decode forwards (decode steps and paged prefill chunks) drop
  the ``w_down`` all-reduce of their first layer: each rank adds only its
  own FFN columns' partial sum to the residual stream there;
* p2: ``wk``'s rank halves are swapped: each rank keeps the other rank's
  key columns (``shard_params`` and ``init_params(mesh=)`` alike);
* p3: the ``lm_head`` logits are gathered in reverse rank order.

Then run the CPU tests (``tests/test_torch_tp.py``,
``tests/test_torch_mesh.py``), the card tests and ``python3
chip_smoke.py`` from DEST. Raises if the text a fault changes is not
found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

LLAMA = "dcos_commons_tpu_torch/models/llama.py"
SWAP = ("_swap(mesh) if {} == \"wk\" else mesh")

# fault -> [(file, text, replacement)], applied in order
FAULTS = {
    "p1": [(LLAMA, "            x = ffn_block(cfg, x, lp, mesh)\n",
            "            x = ffn_block(cfg, x, lp, mesh if i else None)\n")],
    "p2": [(LLAMA, "        out[\"layers\"][key] = shard_leaf(leaf, "
                   "specs[\"layers\"][key], mesh)\n",
            "        out[\"layers\"][key] = shard_leaf(\n"
            "            leaf, specs[\"layers\"][key], "
            + SWAP.format("key") + ")\n"),
           (LLAMA, "            _set(out, path, _shard(leaf, _get(specs, "
                   "path), mesh))\n",
            "            _set(out, path, _shard(leaf, _get(specs, path), "
            + SWAP.format("path[-1]") + "))\n"),
           (LLAMA, "def local_kv_heads(",
            "def _swap(mesh):\n"
            "    coords = dict(mesh.coords)\n"
            "    coords[\"tp\"] = mesh.shape[\"tp\"] - 1 - coords[\"tp\"]\n"
            "    return Mesh(mesh.shape, coords, mesh.device, "
            "mesh.backend, rank=mesh.rank)\n\n\n"
            "def local_kv_heads(")],
    "p3": [(LLAMA, "        logits = mesh.all_gather(logits, \"tp\", dim=-1)\n",
            "        logits = torch.cat(mesh.all_gather(logits, \"tp\", "
            "dim=-1).chunk(\n"
            "            mesh.shape[\"tp\"], dim=-1)[::-1], dim=-1)\n")],
}


def main(argv) -> int:
    if len(argv) != 2 or argv[0] not in FAULTS:
        print(__doc__, file=sys.stderr)
        return 2
    first, *rest = FAULTS[argv[0]]
    rc = plant({argv[0]: first}, __doc__, argv)
    dest = Path(argv[1]).resolve()
    for target, old, new in rest:
        path = dest / target
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{argv[0]}: the text to change occurs "
                             f"{text.count(old)} times in {target}")
        path.write_text(text.replace(old, new))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
