"""How many CUDA cards this host gives the runtime (the port's counterpart
of ``ray_tpu/_private/accelerators/tpu.py``).

JAX's ``TPUAcceleratorManager.detect_num_chips`` counts the TPU chips
``ray_tpu.init()`` schedules; here the accelerator is the CUDA card and
the resource is ``"GPU"``. The count honours ``CUDA_VISIBLE_DEVICES``
(through ``torch.cuda.device_count()``), and ``RAY_TPU_NUM_GPUS``
overrides it as ``RAY_TPU_NUM_CHIPS`` overrides JAX's. torch is imported
only when the count is asked for, so importing the package stays free of
it.
"""

from __future__ import annotations

import os

NUM_GPUS_OVERRIDE_ENV = "RAY_TPU_NUM_GPUS"


def detect_num_cards() -> int:
    """Cards visible to this process: the override when set, 0 when
    ``CUDA_VISIBLE_DEVICES`` hides every card, else
    ``torch.cuda.device_count()``."""
    override = os.environ.get(NUM_GPUS_OVERRIDE_ENV)
    if override is not None:
        return int(override)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip(" ,"):
        return 0
    import torch

    return int(torch.cuda.device_count())
