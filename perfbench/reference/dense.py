"""Plain reference of a dense decoder (Llama / Mistral): float32, TF32
off, one layer's weights at a time, attention over blocks of query rows.

It follows the published architecture: RMSNorm (``x * rsqrt(mean(x**2) +
eps) * scale``), grouped-query attention with rotary embeddings on the
half-split pairs (the ``rotate_half`` convention of the published
checkpoints), causal softmax, SwiGLU MLP, an untied or tied output head.
Weights are ``[in, out]`` matrices stacked ``[layers, ...]`` in a dict;
the reference only reads them, casting one layer at a time.

``quant`` (None or "fp8") computes every matrix product as float8
training and serving do: the operands rounded to float8 e4m3 (per row of
activations, per output column of weights, scaled to the format's range),
the product accumulated in float32, and in a backward pass the product's
incoming gradient rounded to float8 e5m2 (per row, scaled) while the
rounding of the operands passes gradients through unchanged. It is the
lower-precision control of a bf16 configuration. ``quant="bf16"`` rounds
the operands and the incoming gradient to bfloat16 alike: not a control,
but a witness of what bf16 products alone give against float32, which a
sound bf16 program cannot beat (PERF.md).
"""

from __future__ import annotations

import contextlib

import torch

Q_ROWS = 1024          # query rows a block of attention
FP8_MAX = 448.0        # float8 e4m3's largest finite value
E5M2_MAX = 57344.0     # float8 e5m2's largest finite value


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor, dim: int, dtype=torch.float8_e4m3fn,
              top: float = FP8_MAX) -> torch.Tensor:
    """``x`` (float32) rounded to a float8 format with one scale per
    slice along ``dim`` (the slice's absolute maximum mapped to the
    format's largest value), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / top
    return (x / scale).to(dtype).float() * scale


class _Operand(torch.autograd.Function):
    """Forward: round to e4m3 along ``dim``; backward: the gradient
    unchanged."""

    @staticmethod
    def forward(ctx, x, dim):
        return fp8_round(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Product(torch.autograd.Function):
    """Forward: unchanged; backward: the incoming gradient rounded to
    e5m2 along its last dim."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad.float(), -1, torch.float8_e5m2, E5M2_MAX)


class _Bf16(torch.autograd.Function):
    """Forward and backward: rounded to bfloat16, back in float32."""

    @staticmethod
    def forward(ctx, x):
        return x.bfloat16().float()

    @staticmethod
    def backward(ctx, grad):
        return grad.bfloat16().float()


def matmul(a: torch.Tensor, b: torch.Tensor, quant: str | None = None):
    """a [..., K] @ b [K, N] in float32; with ``quant="fp8"`` as float8
    computes it, with ``"bf16"`` with bfloat16 operands (the module's
    docstring)."""
    a, b = a.float(), b.float()
    if quant is None:
        return a @ b
    if quant == "bf16":
        return _Bf16.apply(_Bf16.apply(a) @ _Bf16.apply(b))
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return _Product.apply(_Operand.apply(a, -1) @ _Operand.apply(b, 0))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [T, head_dim / 2] (float64 angles, cast to float32)."""
    inv = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64,
                                  device=positions.device) / head_dim)
    angles = positions.double()[:, None] * inv[None]
    return angles.cos().float(), angles.sin().float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [T, heads, D]: each (i, i + D/2) pair rotated by its angle."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, quant=None):
    """q [T, H, D], k/v [T, Hkv, D] -> [T, H, D]: softmax(q k^T /
    sqrt(D)) v over positions <= each query's, in blocks of query
    rows."""
    t, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)     # [H, T, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, t, Q_ROWS):
        hi = min(t, lo + Q_ROWS)
        qb = q[lo:hi].transpose(0, 1)                          # [H, b, D]
        scores = _bmm(qb, k[:, :hi].transpose(1, 2), quant) * d ** -0.5
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[lo:hi] = _bmm(probs, v[:, :hi], quant).transpose(0, 1)
    return out


def _bmm(a, b, quant):
    if quant is None:
        return torch.bmm(a, b)
    if quant == "bf16":
        return _Bf16.apply(torch.bmm(_Bf16.apply(a), _Bf16.apply(b)))
    return _Product.apply(torch.bmm(_Operand.apply(a, -1),
                                    _Operand.apply(b, -2)))


def layer_weights(params: dict, layer: int) -> dict:
    return {name: w[layer].float() for name, w in params["layers"].items()}


def attention_block(s: dict, x, lw, cos, sin, quant=None):
    """The attention half of a layer on the residual x [T, E]."""
    t = x.shape[0]
    d = s["head_dim"]
    h = rms_norm(x, lw["attn_norm_scale"], s["norm_eps"])
    q = matmul(h, lw["wq"], quant).view(t, -1, d)
    k = matmul(h, lw["wk"], quant).view(t, -1, d)
    v = matmul(h, lw["wv"], quant).view(t, -1, d)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    attn = causal_attention(q, k, v, quant).reshape(t, -1)
    return matmul(attn, lw["wo"], quant)


def mlp_block(s: dict, x, lw, quant=None):
    h = rms_norm(x, lw["mlp_norm_scale"], s["norm_eps"])
    gate = matmul(h, lw["w_gate"], quant)
    up = matmul(h, lw["w_up"], quant)
    return matmul(torch.nn.functional.silu(gate) * up, lw["w_down"], quant)


def head(params: dict):
    w = params.get("lm_head")
    return params["embedding"].T if w is None else w


@torch.no_grad()
def logits(s: dict, params: dict, tokens: list, rows, quant=None):
    """Float32 logits [len(rows), vocab] at positions ``rows`` of the
    sequence ``tokens`` (the logits there predict the next token)."""
    device = params["embedding"].device
    with exact_float32():
        ids = torch.as_tensor(tokens, dtype=torch.long, device=device)
        x = params["embedding"][ids].float()
        cos, sin = rope(torch.arange(len(tokens), device=device),
                        s["head_dim"], s["rope_theta"])
        for layer in range(s["n_layers"]):
            lw = layer_weights(params, layer)
            x = x + attention_block(s, x, lw, cos, sin, quant)
            x = x + mlp_block(s, x, lw, quant)
            del lw
        rows = torch.as_tensor(rows, dtype=torch.long, device=device)
        x = rms_norm(x[rows], params["final_norm_scale"], s["norm_eps"])
        return matmul(x, head(params), quant)


def served_gaps(s: dict, params: dict, prompt: list, served: list,
                quant=None) -> dict:
    """Run the reference once over ``prompt + served`` and read, for each
    served token, how far its logit lies below the reference's best at
    that position. With ``quant`` the reference in lower precision picks
    its own first token at each position, and the gap read is that
    token's under the float32 reference (the control)."""
    tokens = list(prompt) + list(served)
    rows = list(range(len(prompt) - 1, len(tokens) - 1))
    ref = logits(s, params, tokens, rows)
    best = ref.max(dim=-1).values
    if quant is None:
        picked = torch.as_tensor(served, dtype=torch.long,
                                 device=ref.device)
    else:
        picked = logits(s, params, tokens, rows, quant).argmax(dim=-1)
    gaps = best - ref.gather(1, picked[:, None])[:, 0]
    return {"max_gap": float(gaps.max()), "tokens": len(served),
            "mean_gap": float(gaps.mean())}
