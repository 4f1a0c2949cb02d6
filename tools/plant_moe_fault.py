#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's MoE serving
(phase 10), to show which checks catch it.

    python3 tools/plant_moe_fault.py m1|m2|m3 DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one fault:

* m1: the top-2 gates are not renormalised (``top2_dispatch`` in
  ``dcos_commons_tpu_torch/parallel/moe.py``): a fault in the routing
  that ``moe_apply_local`` runs, so phase 10's engine and its own
  reference (``generate_stepwise_moe``) share it;
* m2: the paged engine's prefill chunks skip layer 0's routed FFN
  (``PagedServer._prefill_chunk`` in
  ``dcos_commons_tpu_torch/models/serving.py``): a fault in the engine's
  seam only, the reference untouched;
* m3: a captured window routes without the renormalisation, an eager one
  with it (``top2_dispatch``): a fault in the graph only, which no CPU
  run reaches (the CPU captures nothing).

Then run the CPU tests (``tests/test_torch_moe.py``,
``tests/test_torch_serving_moe.py``, ``tests/test_torch_worker_moe.py``)
and phase 10 of ``chip_smoke.py`` (``phase_moe``) from DEST. Raises if
the text a fault changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

MOE = "dcos_commons_tpu_torch/parallel/moe.py"
SERVING = "dcos_commons_tpu_torch/models/serving.py"
RENORMALISE = "    gate1, gate2 = gate1 / denom, gate2 / denom\n"

FAULTS = {
    "m1": (MOE, RENORMALISE, ""),
    "m2": (SERVING,
           "            self.scratch, rope=self._rope, ffn_override=self._ffn,\n"
           "            mesh=self.mesh)\n"
           "        return logits, end\n",
           "            self.scratch, rope=self._rope,\n"
           "            ffn_override=None if self._ffn is None else (\n"
           "                lambda x, lp: x if lp[\"ffn_norm\"].data_ptr()\n"
           "                == self.params[\"layers\"][\"ffn_norm\"]"
           ".data_ptr()\n"
           "                else self._ffn(x, lp)),\n"
           "            mesh=self.mesh)\n"
           "        return logits, end\n"),
    "m3": (MOE, RENORMALISE,
           "    if not (gates.is_cuda\n"
           "            and torch.cuda.is_current_stream_capturing()):\n"
           "    " + RENORMALISE),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
