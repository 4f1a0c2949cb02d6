#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's expert- and
pipeline-parallel training, to show that the checks catch it.

    python3 tools/plant_ep_pp_fault.py e1|e2|e3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one fault:

* e1: the expert gradients are left ``ep`` times over (``make_train_step``
  in ``dcos_commons_tpu_torch/models/train.py``): the ep-sharded leaves
  are reduced with the stage leaves' weight, not divided by the ep copies
  of each token that every owner receives;
* e2: the embedding gradient is averaged over pp (``pipeline_apply`` in
  ``dcos_commons_tpu_torch/parallel/pipeline.py``): the microbatches skip
  Megatron's "f", so their gradient stays on stage 0, and the mean over
  the mesh divides it by pp;
* e3: the return all-to-all has its axes swapped (``moe_apply`` in
  ``dcos_commons_tpu_torch/parallel/moe.py``): split 0 and concat 1, the
  dispatch's, where the combine needs split 1 and concat 0.

Then run the CPU tests (``tests/test_torch_ep_pp.py``,
``tests/test_torch_worker_ep_pp.py``) and phase 19 of ``chip_smoke.py``
(``phase_ep_pp_train``, ``phase_ep_serve``) from DEST. Raises if the
text a fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

TRAIN = "dcos_commons_tpu_torch/models/train.py"
PIPELINE = "dcos_commons_tpu_torch/parallel/pipeline.py"
MOE = "dcos_commons_tpu_torch/parallel/moe.py"

FAULTS = {
    "e1": (TRAIN, "1.0 / (n if whole == \"ep\" else dp),", "1.0 / dp,"),
    "e2": (PIPELINE, "    xm = mesh.copy_to(x_microbatches, axis)\n",
           "    xm = x_microbatches\n"),
    "e3": (MOE, "expert_out = mesh.all_to_all(expert_out, axis, 1, 0)",
           "expert_out = mesh.all_to_all(expert_out, axis, 0, 1)"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
