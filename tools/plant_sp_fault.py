#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's
sequence-parallel training, to show that the checks catch it.

    python3 tools/plant_sp_fault.py p1|p2|p3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one fault:

* p1: the ring hop is sent the wrong way (``_Ring.hop`` in
  ``dcos_commons_tpu_torch/parallel/ring_attention.py``): each rank
  holds another rank's K/V block than the one its causal skips and masks
  assume (at sp=2 both neighbours are the one peer, so only sp >= 3 can
  show it);
* p2: the zigzag layout's positions do not reach rope (``loss_fn`` in
  ``dcos_commons_tpu_torch/models/llama.py``): each rank's slots rotate
  by its contiguous shard's positions;
* p3: the gradients are not reduced over sp (``make_train_step`` in
  ``dcos_commons_tpu_torch/models/train.py``): each rank applies its own
  sequence shard's share.

Then run the CPU tests (``tests/test_torch_sp.py``,
``tests/test_torch_worker_sp_train.py``) and phase 18a of
``chip_smoke.py`` (``phase_sp_train``) from DEST. Raises if the text a
fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

RING = "dcos_commons_tpu_torch/parallel/ring_attention.py"
LLAMA = "dcos_commons_tpu_torch/models/llama.py"
TRAIN = "dcos_commons_tpu_torch/models/train.py"

FAULTS = {
    "p1": (RING, "self.mesh.ppermute(x, self.axis, 1)",
           "self.mesh.ppermute(x, self.axis, -1)"),
    "p2": (LLAMA, "        positions = (torch.arange(at, at + n, "
                  "device=tokens.device)\n"
                  "                     if positions is None else "
                  "positions[at:at + n])\n",
           "        positions = torch.arange(at, at + n, "
           "device=tokens.device)\n"),
    "p3": (TRAIN, "    grad_axis = {(True, True): GRAD_AXES, (True, False): "
                  "\"dp\",\n"
                  "                 (False, True): \"sp\"}.get((dp > 1, "
                  "sp > 1))\n",
           "    grad_axis = \"dp\" if dp > 1 else None\n"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
