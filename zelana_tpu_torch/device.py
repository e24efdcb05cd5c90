"""Device choice of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no ``device="cpu"``, they raise instead of carrying on on
the CPU.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain versions on the CPU")
    return dev
