"""Normalization ops — counterpart of ``mlrun_tpu/ops/norms.py``.

``rms_norm`` is the plain RMSNorm every model calls. ``rms_norm_pallas``
is the counterpart of the reference's Pallas entry point of the same
name: CUDA tensors launch ``csrc/rms_norm.cu`` (the replacement for the
Pallas ``_rms_norm_kernel``), CPU tensors take the plain version
``rms_norm_pallas_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import _build


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to the input dtype."""
    x32 = x.float()
    variance = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(variance + eps)
    return (normed * scale.float()).to(x.dtype)


def rms_norm_pallas_plain(x: torch.Tensor, scale: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/rms_norm.cu``: the arithmetic of the
    reference's ``_rms_norm_kernel`` (float32 mean of squares, ``rsqrt(var
    + eps)``, times the float32 scale, cast back), which is ``rms_norm``'s."""
    return rms_norm(x, scale, eps)


def _norm_dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float16:
        return _build.FLOAT16_CODE
    return _build.dtype_code(t)


def rms_norm_pallas(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                    block_rows: int = 256) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., F] with scale [F] (the
    reference's signature; ``block_rows`` tiles the Pallas grid and does
    not change the result, so it is only validated here). CUDA tensors
    launch ``csrc/rms_norm.cu``: x in float32, bfloat16 or float16, the
    scale in float32 or x's dtype. CPU tensors take the plain version."""
    if int(block_rows) <= 0:
        raise ValueError(f"rms_norm_pallas: block_rows must be > 0, got "
                         f"{block_rows}")
    if x.device.type == "cpu":
        return rms_norm_pallas_plain(x, scale, eps)
    features = x.shape[-1] if x.dim() else 0
    if scale.shape != (features,):
        raise ValueError(f"rms_norm_pallas: scale {tuple(scale.shape)} does "
                         f"not match x {tuple(x.shape)}")
    for name, t in (("x", x), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"rms_norm_pallas: {name} is on {t.device}, "
                             "expected CUDA")
    code = _norm_dtype_code(x)
    if scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rms_norm_pallas: scale is {scale.dtype}; the "
                        f"kernel takes float32 or x's dtype ({x.dtype})")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // features if features else 0
    if rows == 0:
        return out
    err = _build.library().mlt_rms_norm(
        code, _norm_dtype_code(scale), x.data_ptr(), scale.data_ptr(),
        out.data_ptr(), rows, features, float(eps), _build.stream_ptr(x))
    _build.check_launch("rms_norm", err)
    return out
