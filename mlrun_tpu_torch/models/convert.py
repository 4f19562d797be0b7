"""Weight conversion between the reference package's param tree and the
port's.

The JAX package keeps Llama params as a nested dict of stacked arrays; the
port keeps the same keys and layouts (models/llama.py), so conversion is a
copy both ways. The JAX side is handed over as numpy arrays (for example
``jax.tree.map(np.asarray, params)`` in, ``params_to_numpy`` out) — the
port itself never sees JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device: torch.device | str,
                      dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device``; floating arrays are cast to ``dtype`` when it is given.
    bf16 arrays (numpy's ml_dtypes kind) go through float32, exactly."""
    if isinstance(tree, dict):
        return {key: params_from_numpy(value, device, dtype)
                for key, value in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        tensor = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        tensor = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and tensor.is_floating_point():
        tensor = tensor.to(dtype)
    return tensor.to(device)


def params_to_numpy(tree):
    """The reverse of :func:`params_from_numpy`: a nested dict of torch
    tensors (on any device) -> the same dict of numpy arrays with the JAX
    tree's keys. bf16 tensors come back as float32 arrays, exactly (numpy
    has no bf16 of its own); other dtypes keep theirs."""
    if isinstance(tree, dict):
        return {key: params_to_numpy(value) for key, value in tree.items()}
    tensor = tree.detach()
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    return tensor.cpu().numpy().copy()
