#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's data
parallelism, to show that the checks catch it.

    python3 tools/plant_dp_fault.py p1|p2|p3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one fault:

* p1: batch norm's statistics are not all-reduced
  (``dcos_commons_tpu_torch/models/resnet.py``): each rank normalises
  with its own local batch's mean and variance;
* p2: the gradients are summed over dp, not averaged
  (``Mesh.reduce_grads`` in ``dcos_commons_tpu_torch/parallel/mesh.py``;
  the loss and metric stay means);
* p3: the statistics' all-reduce-mean stays in the forward, and its
  backward is the local identity (``_AllReduceMean.backward``): the loss
  and the state are exact, the gradients are not.

Then run the CPU tests (``tests/test_torch_dp.py``,
``tests/test_torch_mesh.py``, ``tests/test_torch_worker_dp.py``,
``tests/test_torch_gang_e2e.py``) and ``python3 chip_smoke.py`` (or its
phase 16) from DEST. Raises if the text a fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

RESNET = "dcos_commons_tpu_torch/models/resnet.py"
MESH = "dcos_commons_tpu_torch/parallel/mesh.py"

FAULTS = {
    "p1": (RESNET, "        if mesh is not None and mesh.shape[\"dp\"] > 1:\n"
                   "            mean, mean_sq = mesh.all_reduce_mean(",
           "        if False:\n"
           "            mean, mean_sq = mesh.all_reduce_mean("),
    "p2": (MESH, "        n = len(grads)\n        return out[:n],",
           "        n = len(grads)\n"
           "        out[:n] = [g * self.shape[axis] for g in out[:n]]\n"
           "        return out[:n],"),
    "p3": (MESH, "        return mesh.all_reduce(g.clone(), axis) / "
                 "mesh.shape[axis], None, None\n",
           "        return g, None, None\n"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
