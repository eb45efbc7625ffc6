"""Device selection shared by the port's entry points, and the one-crossing
fetch of a small struct of tensors to the host."""

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


def fetch_struct(struct):
    """A NamedTuple of tensors (all on one device, one dtype) fetched to
    the host in ONE device->host copy: the leaves are flattened into one
    tensor, copied, and split back into numpy arrays of the leaves'
    shapes.  The decimated reductions' reports cross this way, one copy
    per collect, not one per field."""
    leaves = list(struct)
    host = torch.cat([v.reshape(-1) for v in leaves]).cpu().numpy()
    out, i = [], 0
    for v in leaves:
        n = v.numel()
        out.append(host[i:i + n].reshape(tuple(v.shape)))
        i += n
    return type(struct)(*out)
