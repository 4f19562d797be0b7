"""Vision Transformer in plain PyTorch — counterpart of
``mlrun_tpu/models/vit.py``.

Patchify is a reshape and one [B·N, P²C] x [P²C, E] product (no
convolution); the encoder is pre-LN with a GELU MLP (the tanh
approximation) and attention that is not causal through
``ops.attention``, which takes the port's flash kernels for every CUDA
tensor, whatever the sequence length (ViT-B/16 at 224 has 197 tokens);
the head reads the cls token. Parameter names follow the Llama tree's
(``wq``/``wk``/``wv``/``wo``, ``w_up``/``w_down``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from .bert import layer_norm
from .llama import logits_f32, normal_init

Params = dict


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_layers: int = 12
    embed_dim: int = 768
    n_heads: int = 12
    mlp_dim: int = 3072
    n_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True
    attention_impl: str = "auto"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads

    def param_count(self) -> int:
        e, m = self.embed_dim, self.mlp_dim
        per_layer = 4 * e * e + 2 * e * m + 4 * e + e + m  # qkvo + mlp + ln
        return (self.patch_dim * e + e + (self.n_patches + 1) * e + e
                + self.n_layers * per_layer + 2 * e
                + e * self.n_classes + self.n_classes)

    def flops_per_image(self) -> float:
        """Training FLOPs an image (fwd+bwd ≈ 6·matmul params a token,
        plus the attention's quadratic term)."""
        e, m, L = self.embed_dim, self.mlp_dim, self.n_layers
        tokens = self.n_patches + 1
        layer_matmul = 4 * e * e + 2 * e * m
        attn = 4 * tokens * e            # qk^T (2·n·e) + pv (2·n·e) a token
        per_token = 6.0 * L * (layer_matmul + attn)
        embed = 6.0 * self.patch_dim * e * self.n_patches
        head = 6.0 * e * self.n_classes
        return per_token * tokens + embed + head


def vit_b16(**overrides) -> ViTConfig:
    return dataclasses.replace(ViTConfig(), **overrides)


def vit_l16(**overrides) -> ViTConfig:
    return dataclasses.replace(ViTConfig(
        n_layers=24, embed_dim=1024, n_heads=16, mlp_dim=4096), **overrides)


def tiny_vit(**overrides) -> ViTConfig:
    """Tiny config for tests."""
    return dataclasses.replace(ViTConfig(
        image_size=32, patch_size=8, n_layers=2, embed_dim=64, n_heads=4,
        mlp_dim=128, n_classes=10, remat=False,
        attention_impl="reference"), **overrides)


def init_params(config: ViTConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random params (normal, scaled by fan_in**-0.5) drawn on ``device``
    from ``generator``, in ``config.dtype``; the head bias is float32, as
    the reference keeps it."""
    dtype = config.dtype
    e, m, L = config.embed_dim, config.mlp_dim, config.n_layers
    normal = normal_init(generator, device, dtype)

    def full(value, *shape, dtype=dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "patch_embedding": normal(config.patch_dim, (config.patch_dim, e)),
        "patch_bias": full(0.0, e),
        "pos_embed": normal(e, (config.n_patches + 1, e)),
        "cls_token": full(0.0, e),
        "layers": {
            "ln1_scale": full(1.0, L, e),
            "ln1_bias": full(0.0, L, e),
            "wq": normal(e, (L, e, e)),
            "wk": normal(e, (L, e, e)),
            "wv": normal(e, (L, e, e)),
            "wo": normal(e, (L, e, e)),
            "ln2_scale": full(1.0, L, e),
            "ln2_bias": full(0.0, L, e),
            "w_up": normal(e, (L, e, m)),
            "up_bias": full(0.0, L, m),
            "w_down": normal(m, (L, m, e)),
            "down_bias": full(0.0, L, e),
        },
        "final_norm_scale": full(1.0, e),
        "final_norm_bias": full(0.0, e),
        "head_w": normal(e, (e, config.n_classes)),
        "head_b": full(0.0, config.n_classes, dtype=torch.float32),
    }


def patchify(config: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, P²C] by pure reshapes (row-major patch
    order, each patch flattened as (row, column, channel))."""
    b, h, w, c = images.shape
    p = config.patch_size
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def _layer_body(config: ViTConfig, x, lp):
    """Pre-LN encoder layer. x: [B, N, E]."""
    b, n, e = x.shape
    h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], config.norm_eps)
    q = (h @ lp["wq"]).reshape(b, n, config.n_heads, config.head_dim)
    k = (h @ lp["wk"]).reshape(b, n, config.n_heads, config.head_dim)
    v = (h @ lp["wv"]).reshape(b, n, config.n_heads, config.head_dim)
    attn = attention(q, k, v, causal=False, impl=config.attention_impl)
    x = x + attn.reshape(b, n, e) @ lp["wo"]
    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], config.norm_eps)
    up = h @ lp["w_up"] + lp["up_bias"].to(x.dtype)
    return x + (F.gelu(up, approximate="tanh") @ lp["w_down"]
                + lp["down_bias"].to(x.dtype))


def encode(config: ViTConfig, params: Params, images: torch.Tensor
           ) -> torch.Tensor:
    """[B, H, W, C] images -> [B, N+1, E] encoded tokens (cls first). With
    ``config.remat`` and autograd recording, each layer is recomputed in
    the backward (the reference's ``jax.checkpoint``)."""
    b = images.shape[0]
    dtype = config.dtype
    patches = patchify(config, images).to(dtype)
    x = patches @ params["patch_embedding"] + params["patch_bias"].to(dtype)
    cls = params["cls_token"].to(dtype).expand(b, 1, config.embed_dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)[None]
    remat = config.remat and torch.is_grad_enabled()
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for layer in range(config.n_layers):
        lp = {name: ws[layer] for name, ws in layers.items()}
        if remat:
            x = checkpoint(_layer_body, config, x, lp, use_reentrant=False)
        else:
            x = _layer_body(config, x, lp)
    return layer_norm(x, params["final_norm_scale"],
                      params["final_norm_bias"], config.norm_eps)


def classify(config: ViTConfig, params: Params, images: torch.Tensor
             ) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_classes] logits (float32, cls-token head)."""
    cls = encode(config, params, images)[:, 0]
    return logits_f32(cls, params["head_w"]) + params["head_b"]


def loss_fn(config: ViTConfig, params: Params, images: torch.Tensor,
            labels: torch.Tensor) -> tuple[torch.Tensor, dict]:
    logits = classify(config, params, images)
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, labels[:, None].long())[:, 0]
    loss = nll.mean()
    accuracy = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": accuracy}


def make_train_step(config: ViTConfig, optimizer, mesh=None, rules=None):
    """Classifier train step: (params, opt_state, images, labels) ->
    (params, opt_state, {"loss", "accuracy", "grad_norm"}), the params
    and moments updated in place by ``optimizer`` (the port's ``AdamW``).
    On a ``mesh`` the params are placed by ``rules`` (default the shared
    table) and the batch splits over ``data`` x ``fsdp``
    (training.train.make_loss_step)."""
    from ..training.train import make_loss_step

    def loss(params, images, labels):
        return loss_fn(config, params, images, labels)

    return make_loss_step(loss, optimizer, mesh=mesh, with_grad_norm=True,
                          rules=rules)
