#!/usr/bin/env python3
"""Copy the repository with one planted fault in the port's ResNet or its
worker, to show that the checks catch it.

    python3 tools/plant_resnet_fault.py a|b|c DEST

DEST receives a copy of the tree (as ``tools/plant_graph_fault.py``
makes it) with one change:

* a: every conv pads symmetrically (``padding=k // 2``, PyTorch's idiom)
  instead of XLA's SAME pads: the same output shapes, other numbers
  wherever SAME is asymmetric (a strided conv on an even size);
* b: batch norm's running variance takes the unbiased batch variance
  (``n / (n - 1)`` times the biased one), as ``nn.BatchNorm2d`` does;
* c: the ``resnet`` worker discards the warm-up step's update (fresh
  optimizer counts after it), so a fresh ``--steps N`` saves Adam count
  N, not N + 1.

Then run the CPU tests (``tests/test_torch_resnet.py``,
``tests/test_torch_worker_resnet.py``), ``python3 chip_smoke.py`` (or its
phase 14) and the card tests from DEST. Raises if the text a fault
changes is not found.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.plant_graph_fault import plant  # noqa: E402

RESNET = "dcos_commons_tpu_torch/models/resnet.py"
WORKER = "dcos_commons_tpu_torch/frameworks/worker.py"

FAULTS = {
    "a": (RESNET, "    return _conv_padded(x, w, stride, _pads(x, w.shape[0], "
                  "stride))\n",
          "    return F.conv2d(x, _oihw(w), stride=stride,\n"
          "                    padding=w.shape[0] // 2)\n"),
    "b": (RESNET, "                  \"var\": m * st[\"var\"] + (1 - m) * var}",
          "                  \"var\": m * st[\"var\"] + (1 - m) * var\n"
          "                  * (x.numel() // x.shape[1])\n"
          "                  / (x.numel() // x.shape[1] - 1)}"),
    "c": (WORKER, "                                            (state, (x, y)))\n"
                  "    float(out[\"loss\"])\n",
          "                                            (state, (x, y)))\n"
          "    float(out[\"loss\"])\n"
          "    opt_state = train.init_opt_state(opt, params)\n"),
}

if __name__ == "__main__":
    sys.exit(plant(FAULTS, __doc__, sys.argv[1:]))
