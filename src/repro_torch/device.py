"""Device selection for the port's entry points.

Every entry point (``Model``, ``init_params``, the bridge, the serving
engine through its model, ``launch.serve``) runs on the card unless the
caller asks for the CPU. Asking for CUDA where there is none is an
error, never a quiet move to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; the port runs on the "
            "card by default — pass device='cpu' to run on the CPU")
    return dev
