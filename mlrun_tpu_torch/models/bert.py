"""BERT-family encoder in plain PyTorch — counterpart of
``mlrun_tpu/models/bert.py``.

The reference's modernized encoder: RoPE instead of learned positions,
pre-LayerNorm, a GELU MLP (the tanh approximation, ``jax.nn.gelu``'s
default), attention that is not causal through ``ops.attention`` (the
port's flash kernels on CUDA). Heads: masked-LM (the tied embedding) and
sequence classification (a mask-weighted mean pool).

The attention mask is not a key-padding mask: padded keys are attended,
and only the padded rows of each layer's attention output are zeroed,
as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.rotary import apply_rope, rope_table
from .llama import normal_init

Params = dict


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    n_layers: int = 12
    embed_dim: int = 768
    n_heads: int = 12
    head_dim: int = 64
    mlp_dim: int = 3072
    rope_theta: float = 10000.0
    norm_eps: float = 1e-12
    n_classes: int = 2
    dtype: Any = torch.bfloat16
    remat: bool = False
    attention_impl: str = "auto"

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        per_layer = (
            4 * self.embed_dim * self.qkv_dim
            + 2 * self.embed_dim * self.mlp_dim
            + 4 * self.embed_dim  # 2 layernorms (scale+bias)
        )
        return (self.vocab_size * self.embed_dim
                + self.n_layers * per_layer
                + 2 * self.embed_dim
                + self.embed_dim * self.n_classes + self.n_classes)


def bert_base(**overrides) -> BertConfig:
    return dataclasses.replace(BertConfig(), **overrides)


def tiny_bert(**overrides) -> BertConfig:
    return dataclasses.replace(BertConfig(
        vocab_size=512, n_layers=2, embed_dim=128, n_heads=4, head_dim=32,
        mlp_dim=256, n_classes=3), **overrides)


def layer_norm(x, scale, bias, eps):
    """LayerNorm with an explicit float32 mean and variance, cast back to
    x's dtype (the reference's arithmetic, not ``F.layer_norm``'s)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def init_params(config: BertConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random params (normal, scaled by fan_in**-0.5) drawn on ``device``
    from ``generator``, in ``config.dtype``; the classifier bias is
    float32, as the reference keeps it."""
    dtype = config.dtype
    e, h, m, L = (config.embed_dim, config.qkv_dim, config.mlp_dim,
                  config.n_layers)
    normal = normal_init(generator, device, dtype)

    def full(value, *shape, dtype=dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "embedding": normal(e, (config.vocab_size, e)),
        "layers": {
            "attn_norm_scale": full(1.0, L, e),
            "attn_norm_bias": full(0.0, L, e),
            "wq": normal(e, (L, e, h)),
            "wk": normal(e, (L, e, h)),
            "wv": normal(e, (L, e, h)),
            "wo": normal(h, (L, h, e)),
            "mlp_norm_scale": full(1.0, L, e),
            "mlp_norm_bias": full(0.0, L, e),
            "w_up": normal(e, (L, e, m)),
            "w_down": normal(m, (L, m, e)),
        },
        "final_norm_scale": full(1.0, e),
        "final_norm_bias": full(0.0, e),
        "classifier_w": normal(e, (e, config.n_classes)),
        "classifier_b": full(0.0, config.n_classes, dtype=torch.float32),
    }


def _layer_body(config: BertConfig, x, lp, cos, sin, mask):
    b, s, _ = x.shape
    h = layer_norm(x, lp["attn_norm_scale"], lp["attn_norm_bias"],
                   config.norm_eps)
    q = (h @ lp["wq"]).reshape(b, s, config.n_heads, config.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, config.n_heads, config.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, config.n_heads, config.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, causal=False, impl=config.attention_impl)
    if mask is not None:
        attn = attn * mask[:, :, None, None].to(attn.dtype)
    x = x + attn.reshape(b, s, config.qkv_dim) @ lp["wo"]
    h2 = layer_norm(x, lp["mlp_norm_scale"], lp["mlp_norm_bias"],
                    config.norm_eps)
    up = h2 @ lp["w_up"]
    return x + F.gelu(up, approximate="tanh") @ lp["w_down"]


def encode(config: BertConfig, params: Params, tokens: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, S] (+ attention mask [B, S]) -> hidden [B, S, E]. With
    ``config.remat`` and autograd recording, each layer is recomputed in
    the backward (``torch.utils.checkpoint``)."""
    x = params["embedding"][tokens].to(config.dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    remat = config.remat and torch.is_grad_enabled()
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for layer in range(config.n_layers):
        lp = {name: ws[layer] for name, ws in layers.items()}
        if remat:
            x = checkpoint(_layer_body, config, x, lp, cos, sin, mask,
                           use_reentrant=False)
        else:
            x = _layer_body(config, x, lp, cos, sin, mask)
    return layer_norm(x, params["final_norm_scale"],
                      params["final_norm_bias"], config.norm_eps)


def classify(config: BertConfig, params: Params, tokens: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sequence classification logits [B, n_classes] (mean-pool head)."""
    hidden = encode(config, params, tokens, mask).float()
    if mask is not None:
        weights = mask.float()[:, :, None]
        pooled = (hidden * weights).sum(dim=1) / torch.clamp_min(
            weights.sum(dim=1), 1.0)
    else:
        pooled = hidden.mean(dim=1)
    return pooled @ params["classifier_w"].float() + params["classifier_b"]


def mlm_logits(config: BertConfig, params: Params, tokens: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked-LM logits [B, S, vocab] in float32 (tied embedding head)."""
    hidden = encode(config, params, tokens, mask)
    return torch.einsum("bse,ve->bsv", hidden.float(),
                        params["embedding"].float())


def _nll(logits, labels):
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.gather(log_probs, -1, labels[..., None].long())[..., 0]


def classification_loss(config: BertConfig, params: Params, tokens, labels,
                        mask=None) -> tuple[torch.Tensor, dict]:
    logits = classify(config, params, tokens, mask)
    loss = _nll(logits, labels).mean()
    accuracy = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": accuracy}


def mlm_loss(config: BertConfig, params: Params, tokens, targets,
             mlm_mask) -> tuple[torch.Tensor, dict]:
    """mlm_mask: 1 where the token was masked and should be predicted."""
    logits = mlm_logits(config, params, tokens)
    weight = mlm_mask.float()
    total = torch.clamp_min(weight.sum(), 1.0)
    loss = (_nll(logits, targets) * weight).sum() / total
    return loss, {"loss": loss, "masked_tokens": total}


def make_classifier_train_step(config: BertConfig, optimizer, mesh=None):
    """Classification train step: (params, opt_state, tokens, labels,
    mask) -> (params, opt_state, {"loss", "accuracy"}), the params and
    moments updated in place by ``optimizer`` (the port's ``AdamW``). On
    a ``mesh`` the params are placed by the shared rules ('wk'/'wv' here
    are full-head, so the Llama rules apply) and the batch splits over
    ``data`` x ``fsdp`` (training.train.make_loss_step)."""
    from ..training.train import make_loss_step

    def loss(params, tokens, labels, mask):
        return classification_loss(config, params, tokens, labels, mask)

    return make_loss_step(loss, optimizer, mesh=mesh, with_grad_norm=False)
