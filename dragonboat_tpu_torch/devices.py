"""Device selection shared by the port's entry points, the upload of a
host array and the out-of-place row write, and the one-crossing fetch of
a small struct of tensors to the host."""

from __future__ import annotations

import numpy as np
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


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host staging array as a tensor of the same dtype on ``device``.
    On the CPU the tensor is a copy, never a view: the staging buffers are
    reset and rewritten while a step that consumed them may still hold
    its inputs."""
    t = torch.from_numpy(a)
    return t.clone() if device.type == "cpu" else t.to(device)


def put_rows(arr: torch.Tensor, rows, vals) -> torch.Tensor:
    """``arr`` with ``arr[rows] = vals`` (out of place; ``vals``
    broadcasts over the selected rows and takes ``arr``'s dtype).
    ``rows`` is an index tensor on ``arr``'s device, or one row as a
    Python int (nothing is uploaded for it).  A Python scalar is filled on
    ``arr``'s device, not copied from the host."""
    if isinstance(vals, torch.Tensor):
        v = vals.to(device=arr.device, dtype=arr.dtype)
    else:
        v = torch.full((), vals, dtype=arr.dtype, device=arr.device)
    if isinstance(rows, int):
        out = arr.clone()
        out[rows:rows + 1] = v
        return out
    return arr.index_put((rows,), v.expand((rows.shape[0],) + arr.shape[1:]))
