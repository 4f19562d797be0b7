"""Torch packagers — tensors and param trees (the port's counterpart of
``mlrun_tpu/package/packagers/jax_packagers.py``). 0-d tensors land as
results, others as ``.npy`` artifacts, nested dicts / lists of tensors (a
port param tree, a ``state_dict``) as one ``.npz`` keyed by ``/``-joined
paths. A tensor on the card (or a DTensor) is copied to the host first.

bfloat16 needs no ``ml_dtypes``: its 16-bit patterns are stored as a
structured array with one ``<u2`` field named ``bfloat16``, which numpy
reads everywhere and :func:`from_host` turns back into the same bits.
"""

from __future__ import annotations

from .default import DefaultPackager

BF16_FIELD = "bfloat16"


def _is_tensor(obj) -> bool:
    try:
        import torch

        return isinstance(obj, torch.Tensor)
    except ImportError:
        return False


def to_host(tensor):
    """``tensor`` as a numpy array, bit for bit (bfloat16 as its tagged
    16-bit patterns)."""
    import numpy as np
    import torch

    tensor = tensor.detach()
    if hasattr(tensor, "full_tensor"):  # a DTensor: every rank's part
        tensor = tensor.full_tensor()
    tensor = tensor.cpu().contiguous()
    if tensor.dtype == torch.bfloat16:
        bits = tensor.view(torch.int16).numpy().view(np.uint16)
        return bits.view(np.dtype([(BF16_FIELD, "<u2")]))
    return tensor.numpy()


def from_host(array):
    """The tensor :func:`to_host` stored (a writable copy)."""
    import numpy as np
    import torch

    array = np.asarray(array)
    if array.dtype.names == (BF16_FIELD,):
        bits = np.ascontiguousarray(array).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(array))


def flatten_tree(tree, prefix: str = "") -> dict:
    """``{"a/b/0": leaf, ...}`` for nested dicts and lists. ``None`` is an
    empty subtree, as ``jax.tree_util.tree_leaves`` treats it: it gives no
    leaf, so a tree of ``None`` alone has none."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}/{key}" if prefix
                                else str(key)))
    return out


def unflatten_tree(flat: dict) -> dict:
    """Nested dicts from ``/``-joined paths (list levels come back as
    dicts keyed "0", "1", ...). A ``None`` of the packed tree had no path,
    so it is left out."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


class TorchTensorPackager(DefaultPackager):
    artifact_types = ("artifact", "result", "file")
    priority = 3

    def can_pack(self, obj):
        return _is_tensor(obj)

    def can_unpack(self, hint):
        try:
            import torch

            return hint is torch.Tensor
        except ImportError:
            return False

    def pack(self, context, obj, key, artifact_type="", **cfg):
        import numpy as np

        if obj.ndim == 0 or artifact_type == "result":
            host = obj.detach().float() if obj.is_floating_point() \
                else obj.detach()
            context.log_result(
                key, host.item() if obj.ndim == 0 else host.tolist())
            return
        path = self.new_file(".npy")
        np.save(path, to_host(obj))
        context.log_artifact(key, local_path=path, format="npy")

    def unpack(self, data_item, hint):
        import numpy as np

        return from_host(np.load(data_item.local()))


class TorchTreePackager(DefaultPackager):
    """Nested dict / list trees whose leaves are tensors → one npz with
    '/'-joined key paths."""

    priority = 3

    def can_pack(self, obj):
        if not isinstance(obj, (dict, list)) or not obj:
            return False
        leaves = flatten_tree(obj).values()
        return bool(leaves) and all(_is_tensor(x) for x in leaves)

    def can_unpack(self, hint):
        return False  # dict/list hints route to the collection packager

    def pack(self, context, obj, key, artifact_type="", **cfg):
        import numpy as np

        flat = {name: to_host(leaf)
                for name, leaf in flatten_tree(obj).items()}
        out = self.new_file(".npz")
        np.savez(out, **flat)
        context.log_artifact(key, local_path=out, format="npz")

    def unpack(self, data_item, hint):
        import numpy as np

        with np.load(data_item.local()) as loaded:
            return unflatten_tree({name: from_host(loaded[name])
                                   for name in loaded.files})
