"""Where the port's entry points run."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it resolves to ``cuda`` and raises when
    CUDA is absent, so a run never carries on silently on the CPU.  The
    CPU is used only when the caller names it (``device="cpu"``), as the
    tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
