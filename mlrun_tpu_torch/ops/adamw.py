"""Fused AdamW on the card: the two multi-tensor kernels of
``csrc/adamw.cu`` behind ``training/train.py``'s ``AdamW``.

``grad_sqnorm`` launches ``mlt_grad_sqnorm`` (one pass over every
gradient leaf: the sum of squares, the global norm and the clip's scale,
left on the device); ``adamw`` launches ``mlt_adamw`` (one pass over every
leaf: each element's g, p, mu and nu read once, p, mu and nu written once,
in place). No Pallas kernel is replaced: on the TPU, XLA fuses optax's
update by itself. The plain version is ``AdamW``'s per-leaf loop of
PyTorch ops, which CPU leaves take; a CUDA leaf always takes these
kernels, and a leaf they do not take (float16, say) raises. Leaves are
float32 or bfloat16, each with its own dtype; p, mu and nu share one.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# float64 partial sums of grad_sqnorm, one buffer per (device, stream),
# grown when a tree needs more and reused across steps
_scratch: dict = {}


def _check(name: str, tensors: list, like: list | None = None):
    for i, t in enumerate(tensors):
        if t.device.type != "cuda":
            raise ValueError(f"fused adamw: {name}[{i}] is on {t.device}, "
                             "expected CUDA")
        _build.dtype_code(t)  # float32 or bfloat16, else TypeError
        if like is not None and t.shape != like[i].shape:
            raise ValueError(f"fused adamw: {name}[{i}] has shape "
                             f"{tuple(t.shape)}, its param "
                             f"{tuple(like[i].shape)}")


def check_leaves(params: list, grads: list, mus: list, nus: list):
    """Raise unless every leaf is a CUDA float32 or bfloat16 tensor, the
    lists match in length and shape, mu and nu share their param's dtype
    and the tensors updated in place are contiguous."""
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError(f"fused adamw: {len(params)} params, {len(grads)} "
                         f"grads, {len(mus)} mu, {len(nus)} nu")
    _check("params", params)
    _check("grads", grads, params)
    for name, group in (("mu", mus), ("nu", nus)):
        _check(name, group, params)
        for i, (t, p) in enumerate(zip(group, params)):
            if t.dtype != p.dtype:
                raise TypeError(f"fused adamw: {name}[{i}] is {t.dtype}, "
                                f"its param {p.dtype}")
    for name, group in (("params", params), ("mu", mus), ("nu", nus)):
        for i, t in enumerate(group):
            if not t.is_contiguous():
                raise ValueError(f"fused adamw: {name}[{i}] is not "
                                 "contiguous (it is updated in place)")


def _ptrs(tensors: list):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values: list, ctype=ctypes.c_int):
    return (ctype * len(values))(*values)


def _partials(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = _scratch[key] = torch.empty(n, dtype=torch.float64,
                                          device=device)
    return buf


def grad_sqnorm(grads: list, max_norm: float = 0.0,
                finish: bool = True) -> torch.Tensor:
    """float32 [sum of g**2 over every leaf, g_norm, divisor, factor] on
    the device, in one ``mlt_grad_sqnorm`` call (no host sync). The clip's
    ``divisor`` / ``factor`` are ``g_norm`` / ``max_norm`` where ``g_norm
    >= max_norm``, else 1 / 1. Without ``finish`` only the sum is written
    (a sharded step all-reduces it first)."""
    if not grads:
        raise ValueError("fused adamw: no gradient leaves")
    _check("grads", grads)
    grads = [g.contiguous() for g in grads]
    device = grads[0].device
    stream = _build.stream_ptr(grads[0])
    lib = _build.library()
    partials = _partials(device, stream, lib.mlt_grad_sqnorm_scratch(
        len(grads)))
    out = torch.empty(4, dtype=torch.float32, device=device)
    err = lib.mlt_grad_sqnorm(
        len(grads), _ptrs(grads), _ints([g.numel() for g in grads],
                                        ctypes.c_longlong),
        _ints([_build.dtype_code(g) for g in grads]), partials.data_ptr(),
        partials.numel(), out.data_ptr(), int(finish),
        float(np.float32(max_norm)), stream)
    _build.check_launch("grad_sqnorm", err)
    return out


def adamw(params: list, grads: list, mus: list, nus: list, *, lr: float,
          b1: float, b2: float, eps: float, weight_decay: float, bc1: float,
          bc2: float, scale: torch.Tensor | None = None):
    """One AdamW update of every leaf in place, in one ``mlt_adamw`` call:
    the plain loop's arithmetic with its constants cast as its PyTorch ops
    cast their Python scalar operands (to float32; a division by one is a
    product with its float32 reciprocal). ``scale``: the clip's [divisor,
    factor] on the device, or None for no clip."""
    check_leaves(params, grads, mus, nus)
    if not params:
        return
    if scale is not None and (scale.device.type != "cuda"
                              or scale.dtype != torch.float32
                              or scale.numel() != 2
                              or not scale.is_contiguous()):
        raise ValueError("fused adamw: scale is [divisor, factor], two "
                         "contiguous float32 values on the card")
    grads = [g.contiguous() for g in grads]
    f32 = np.float32
    one = f32(1.0)
    err = _build.library().mlt_adamw(
        len(params), _ptrs(params), _ptrs(grads), _ptrs(mus), _ptrs(nus),
        _ints([p.numel() for p in params], ctypes.c_longlong),
        _ints([_build.dtype_code(p) for p in params]),
        _ints([_build.dtype_code(g) for g in grads]),
        None if scale is None else scale.data_ptr(),
        float(f32(b1)), float(f32(1.0 - b1)), float(f32(b2)),
        float(f32(1.0 - b2)), float(one / f32(bc1)), float(one / f32(bc2)),
        float(f32(eps)), float(f32(weight_decay)), int(bool(weight_decay)),
        float(f32(-lr)), _build.stream_ptr(params[0]))
    _build.check_launch("adamw", err)
