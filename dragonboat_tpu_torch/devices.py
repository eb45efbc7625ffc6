"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card: with no card present this raises rather
    than quietly running on the CPU.  The CPU runs only when the caller
    names it (``device="cpu"``), as the CPU tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch arms on the CPU")
        return torch.device("cuda")
    return torch.device(device)
