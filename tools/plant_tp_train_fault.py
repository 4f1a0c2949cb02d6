#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's
tensor-parallel training, to show that the checks catch it.

    python3 tools/plant_tp_train_fault.py p1|p2|p3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one fault:

* p1: Megatron's "f" is the identity both ways (``_CopyTo.backward`` in
  ``dcos_commons_tpu_torch/parallel/mesh.py``): each rank's gradient of a
  column-parallel product's input stays partial, so the residual stream's
  and the norms' gradients are wrong and the ranks' norms drift apart;
* p2: the clip's norm is the rank's own (``_global_norm`` in
  ``dcos_commons_tpu_torch/models/train.py``): the sharded leaves'
  squares are not summed over tp, so each rank clips by its own factor;
* p3: the vocabulary-parallel loss takes a local logsumexp
  (``_FusedLCETP.forward`` in ``dcos_commons_tpu_torch/ops/losses.py``):
  each rank normalises over its own V/tp columns only.

Then run the CPU tests (``tests/test_torch_tp_train.py``,
``tests/test_torch_mesh.py``, ``tests/test_torch_worker_tp_train.py``)
and ``python3 chip_smoke.py`` (or its phase 17) from DEST. Raises if the
text a fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

MESH = "dcos_commons_tpu_torch/parallel/mesh.py"
TRAIN = "dcos_commons_tpu_torch/models/train.py"
LOSSES = "dcos_commons_tpu_torch/ops/losses.py"

FAULTS = {
    "p1": (MESH, "        return ctx.mesh.all_reduce(g.clone(), ctx.axis), "
                 "None, None\n",
           "        return g, None, None\n"),
    "p2": (TRAIN, "        total = total + mesh.all_reduce(part.reshape(1), "
                  "axis)[0]",
           "        total = total + part"),
    "p3": (LOSSES, "            lz = top + torch.log(sums[0])",
           "            lz = top + torch.log(parts[0])"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
