"""T5-style encoder-decoder in plain PyTorch — counterpart of
``mlrun_tpu/models/t5.py``.

A relative position bias (one bucket table a stack, shared by its layers)
is added inside a float32-softmax attention with no softmax scale. The
bias makes the score matrix non-factorable, so this attention is plain
PyTorch in the port as it is plain XLA in the reference: T5 reaches no
kernel. Gated-GELU feed-forward (T5.1.1, the tanh approximation) with
Llama's ``w_gate``/``w_up``/``w_down`` names, RMS norm, and a tied head
scaled by ``embed_dim ** -0.5``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.norms import rms_norm
from .llama import logits_f32, normal_init

Params = dict
NEG_INF = -2.0 ** 30


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    embed_dim: int = 768
    n_heads: int = 12
    head_dim: int = 64
    mlp_dim: int = 2048
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True
    tie_embeddings: bool = True

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        e, h, m = self.embed_dim, self.qkv_dim, self.mlp_dim
        enc_layer = 4 * e * h + 3 * e * m + 2 * e
        dec_layer = 8 * e * h + 3 * e * m + 3 * e
        total = (self.vocab_size * e
                 + self.n_enc_layers * enc_layer
                 + self.n_dec_layers * dec_layer
                 + 2 * self.rel_buckets * self.n_heads + 2 * e)
        if not self.tie_embeddings:
            total += e * self.vocab_size
        return total

    def flops_per_token(self, enc_len: int, dec_len: int) -> float:
        """Training FLOPs a decoder token (fwd+bwd ≈ 6·matmul params a
        token plus the attention's quadratic terms; the encoder's tokens
        amortized over the decoder's)."""
        e, h, m = self.embed_dim, self.qkv_dim, self.mlp_dim
        enc = self.n_enc_layers * (4 * e * h + 3 * e * m + 4 * enc_len * h)
        dec = self.n_dec_layers * (8 * e * h + 3 * e * m
                                   + 4 * dec_len * h + 4 * enc_len * h)
        head = e * self.vocab_size
        return 6.0 * (enc * (enc_len / max(1, dec_len)) + dec + head)


def t5_base(**overrides) -> T5Config:
    return dataclasses.replace(T5Config(), **overrides)


def t5_large(**overrides) -> T5Config:
    return dataclasses.replace(T5Config(
        n_enc_layers=24, n_dec_layers=24, embed_dim=1024, n_heads=16,
        mlp_dim=2816), **overrides)


def tiny_t5(**overrides) -> T5Config:
    """Tiny config for tests."""
    return dataclasses.replace(T5Config(
        vocab_size=256, n_enc_layers=2, n_dec_layers=2, embed_dim=64,
        n_heads=4, head_dim=16, mlp_dim=128, rel_buckets=8,
        rel_max_distance=32, remat=False), **overrides)


# -- init ----------------------------------------------------------------------

_ENC_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_DEC_LEAVES = ("wq", "wk", "wv", "wo", "cross_wq", "cross_wk", "cross_wv",
               "cross_wo", "w_gate", "w_up", "w_down")


def init_params(config: T5Config, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random params (normal, scaled by fan_in**-0.5) drawn on ``device``
    from ``generator``, in ``config.dtype``; the relative bias tables are
    float32 zeros, as the reference keeps them."""
    dtype = config.dtype
    e, h, m = config.embed_dim, config.qkv_dim, config.mlp_dim
    normal = normal_init(generator, device, dtype)
    # [in, out] of each projection, by name
    dims = {"wq": (e, h), "wk": (e, h), "wv": (e, h), "wo": (h, e),
            "cross_wq": (e, h), "cross_wk": (e, h), "cross_wv": (e, h),
            "cross_wo": (h, e), "w_gate": (e, m), "w_up": (e, m),
            "w_down": (m, e)}

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def stack(n_layers, names, norms):
        tree = {name: ones(n_layers, e) for name in norms}
        for name in names:
            fan_in, fan_out = dims[name]
            tree[name] = normal(fan_in, (n_layers, fan_in, fan_out))
        return tree

    def rel_table():
        return torch.zeros((config.rel_buckets, config.n_heads),
                           dtype=torch.float32, device=device)

    params: Params = {
        "embedding": normal(e, (config.vocab_size, e)),
        "enc_rel_bias": rel_table(),
        "dec_rel_bias": rel_table(),
        "encoder": stack(config.n_enc_layers, _ENC_LEAVES,
                         ("attn_norm_scale", "mlp_norm_scale")),
        "decoder": stack(config.n_dec_layers, _DEC_LEAVES,
                         ("attn_norm_scale", "cross_norm_scale",
                          "mlp_norm_scale")),
        "enc_final_norm_scale": ones(e),
        "final_norm_scale": ones(e),
    }
    if not config.tie_embeddings:
        params["lm_head"] = normal(e, (e, config.vocab_size))
    return params


# -- relative position bias ----------------------------------------------------

def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5 bucketing: half the buckets exact, half log-spaced out to
    ``max_distance`` (bidirectional splits the space by sign). Both logs
    are float32, as the reference's ``jnp.log`` computes them, and the
    bucket truncates toward zero, so positions land in the reference's
    buckets exactly."""
    pos = relative_position
    bucket = torch.zeros_like(pos)
    if bidirectional:
        num_buckets = num_buckets // 2
        bucket = bucket + (pos > 0).to(pos.dtype) * num_buckets
        pos = pos.abs()
    else:
        pos = -torch.clamp_max(pos, 0)
    max_exact = num_buckets // 2
    is_small = pos < max_exact
    span = torch.log(torch.tensor(max_distance / max_exact,
                                  dtype=torch.float32, device=pos.device))
    log_pos = max_exact + (
        torch.log(pos.clamp_min(1).float() / max_exact) / span
        * (num_buckets - max_exact)).to(pos.dtype)
    log_pos = torch.clamp_max(log_pos, num_buckets - 1)
    return bucket + torch.where(is_small, pos, log_pos)


def rel_bias(config: T5Config, table: torch.Tensor, q_len: int, k_len: int,
             bidirectional: bool) -> torch.Tensor:
    """[buckets, heads] table -> [heads, q_len, k_len] additive bias."""
    device = table.device
    rel = (torch.arange(k_len, device=device)[None, :]
           - torch.arange(q_len, device=device)[:, None])
    buckets = relative_position_bucket(
        rel, bidirectional, config.rel_buckets, config.rel_max_distance)
    return table[buckets].permute(2, 0, 1)


# -- forward -------------------------------------------------------------------

def _biased_attention(q, k, v, bias, mask=None):
    """[B, S, H, D] attention with an additive [H, Sq, Sk] bias, no softmax
    scale, float32 logits and softmax. ``mask``: [B, Sk], True = attend
    (key padding)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits = logits + bias[None]
    if mask is not None:
        logits = torch.where(mask.bool()[:, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _heads(x, config: T5Config):
    b, s, _ = x.shape
    return x.reshape(b, s, config.n_heads, config.head_dim)


def _ffn(config: T5Config, x, lp):
    h = rms_norm(x, lp["mlp_norm_scale"], config.norm_eps)
    gate = h @ lp["w_gate"]
    up = h @ lp["w_up"]
    return x + (F.gelu(gate, approximate="tanh") * up) @ lp["w_down"]


def _enc_layer(config: T5Config, bias, mask, x, lp):
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
    attn = _biased_attention(_heads(h @ lp["wq"], config),
                             _heads(h @ lp["wk"], config),
                             _heads(h @ lp["wv"], config), bias, mask)
    x = x + attn.reshape(b, s, config.qkv_dim) @ lp["wo"]
    return _ffn(config, x, lp)


def _dec_layer(config: T5Config, self_bias, enc_out, enc_mask, x, lp):
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
    attn = _biased_attention(_heads(h @ lp["wq"], config),
                             _heads(h @ lp["wk"], config),
                             _heads(h @ lp["wv"], config), self_bias)
    x = x + attn.reshape(b, s, config.qkv_dim) @ lp["wo"]
    h = rms_norm(x, lp["cross_norm_scale"], config.norm_eps)
    attn = _biased_attention(_heads(h @ lp["cross_wq"], config),
                             _heads(enc_out @ lp["cross_wk"], config),
                             _heads(enc_out @ lp["cross_wv"], config), None,
                             enc_mask)
    x = x + attn.reshape(b, s, config.qkv_dim) @ lp["cross_wo"]
    return _ffn(config, x, lp)


def _run_stack(config: T5Config, layer, x, stack: Params, *args):
    """Run ``layer(config, *args, x, lp)`` over a stacked layer tree, each
    layer under ``torch.utils.checkpoint`` when ``config.remat`` is set
    and autograd is recording."""
    remat = config.remat and torch.is_grad_enabled()
    layers = {name: w.unbind(0) for name, w in stack.items()}
    n_layers = next(iter(stack.values())).shape[0]
    for i in range(n_layers):
        lp = {name: ws[i] for name, ws in layers.items()}
        if remat:
            x = checkpoint(layer, config, *args, x, lp, use_reentrant=False)
        else:
            x = layer(config, *args, x, lp)
    return x


def encode(config: T5Config, params: Params, input_ids: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, S] token ids -> [B, S, E] encoded states."""
    s = input_ids.shape[1]
    x = params["embedding"][input_ids].to(config.dtype)
    bias = rel_bias(config, params["enc_rel_bias"], s, s, bidirectional=True)
    x = _run_stack(config, _enc_layer, x, params["encoder"], bias, mask)
    return rms_norm(x, params["enc_final_norm_scale"], config.norm_eps)


def decode(config: T5Config, params: Params, enc_out: torch.Tensor,
           dec_ids: torch.Tensor, enc_mask: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Teacher-forced decode: [B, T] target ids -> [B, T, vocab] float32
    logits."""
    t = dec_ids.shape[1]
    x = params["embedding"][dec_ids].to(config.dtype)
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=dec_ids.device).tril()
    bias = rel_bias(config, params["dec_rel_bias"], t, t,
                    bidirectional=False)
    bias = torch.where(causal[None], bias, torch.full_like(bias, NEG_INF))
    x = _run_stack(config, _dec_layer, x, params["decoder"], bias, enc_out,
                   enc_mask)
    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    if config.tie_embeddings:
        # T5 scales tied-embedding logits by d_model^-0.5
        head = params["embedding"].T * (config.embed_dim ** -0.5)
    else:
        head = params["lm_head"]
    return logits_f32(x, head)


def seq2seq_loss(config: T5Config, params: Params, input_ids: torch.Tensor,
                 dec_ids: torch.Tensor, targets: torch.Tensor,
                 enc_mask: torch.Tensor | None = None,
                 target_mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, dict]:
    """Cross-entropy over decoder positions (mask 0 = padding)."""
    enc_out = encode(config, params, input_ids, enc_mask)
    logits = decode(config, params, enc_out, dec_ids, enc_mask)
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    if target_mask is None:
        target_mask = torch.ones(targets.shape, dtype=torch.float32,
                                 device=targets.device)
    target_mask = target_mask.float()
    total = torch.clamp_min(target_mask.sum(), 1.0)
    loss = (nll * target_mask).sum() / total
    accuracy = ((torch.argmax(logits, dim=-1) == targets).float()
                * target_mask).sum() / total
    return loss, {"loss": loss, "accuracy": accuracy}


def make_train_step(config: T5Config, optimizer, mesh=None, rules=None):
    """Seq2seq train step: (params, opt_state, input_ids, dec_ids,
    targets) -> (params, opt_state, {"loss", "accuracy", "grad_norm"}),
    the params and moments updated in place by ``optimizer`` (the port's
    ``AdamW``). On a ``mesh`` the params are placed by ``rules`` (default
    the shared table) and the batch splits over ``data`` x ``fsdp``
    (training.train.make_loss_step)."""
    from ..training.train import make_loss_step

    def loss(params, input_ids, dec_ids, targets):
        return seq2seq_loss(config, params, input_ids, dec_ids, targets)

    return make_loss_step(loss, optimizer, mesh=mesh, with_grad_norm=True,
                          rules=rules)
