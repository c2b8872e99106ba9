"""Where the port's tensors live.

Every public constructor that allocates on a device takes `device`,
"cuda" by default: the card unless the caller asks for the CPU, as the
tests do. `require_device` turns the name into a torch.device and raises
when the card is asked for and none is present, so nothing moves to the
CPU quietly.
"""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False: this runs "
            "on the card; pass device='cpu' to run it on the CPU"
        )
    return dev
