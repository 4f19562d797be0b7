"""LoRA adapters for the stacked-layer Llama parameter tree — counterpart
of ``mlrun_tpu/models/lora.py``.

An adapter mirrors the layer stack: for each adapted projection
``{"lora_a": [L, in, r], "lora_b": [L, r, out], "scaling": [L]}`` (alpha /
rank per layer), all float32. Training updates these tensors only (the
base params stay frozen, training/train.py); serving stacks many of them
into a device bank gathered per batch row (serving/adapters.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .llama import LlamaConfig, Params

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")
_PROJ_DIMS = {
    "wq": lambda c: (c.embed_dim, c.qkv_dim),
    "wk": lambda c: (c.embed_dim, c.kv_dim),
    "wv": lambda c: (c.embed_dim, c.kv_dim),
    "wo": lambda c: (c.qkv_dim, c.embed_dim),
    "w_gate": lambda c: (c.embed_dim, c.mlp_dim),
    "w_up": lambda c: (c.embed_dim, c.mlp_dim),
    "w_down": lambda c: (c.mlp_dim, c.embed_dim),
}


class LoraShapeError(ValueError):
    """An adapter's rank/shape disagrees with the base params (or with
    another adapter sharing a serving bank). Subclasses ValueError so
    pre-typed callers keep working."""


def init_lora(config: LlamaConfig, generator: torch.Generator,
              rank: int = 16, alpha: float = 32.0,
              targets: Sequence[str] = DEFAULT_TARGETS,
              device: torch.device | str = "cpu") -> Params:
    """Initialize LoRA adapters (A ~ normal/sqrt(in), B = 0), drawn on
    ``device`` from ``generator`` (which must live on that device)."""
    lora: Params = {}
    for target in targets:
        if target not in _PROJ_DIMS:
            raise ValueError(f"unknown lora target '{target}'")
        d_in, d_out = _PROJ_DIMS[target](config)
        lora[target] = {
            "lora_a": torch.randn((config.n_layers, d_in, rank),
                                  generator=generator, device=device,
                                  dtype=torch.float32) * (d_in ** -0.5),
            "lora_b": torch.zeros((config.n_layers, rank, d_out),
                                  dtype=torch.float32, device=device),
            # per layer, so a layer's view carries its own scale
            "scaling": torch.full((config.n_layers,), alpha / rank,
                                  dtype=torch.float32, device=device),
        }
    return lora


def init_lora_nonzero(config: LlamaConfig, generator: torch.Generator,
                      rank: int = 16, alpha: float = 32.0,
                      targets: Sequence[str] = DEFAULT_TARGETS,
                      b_scale: float = 0.05,
                      device: torch.device | str = "cpu") -> Params:
    """:func:`init_lora` with a random (nonzero) B factor — a synthetic
    "trained" adapter whose delta moves logits, for exercising the
    multi-tenant serving path (``init_lora``'s B = 0 is a zero delta)."""
    lora = init_lora(config, generator, rank=rank, alpha=alpha,
                     targets=targets, device=device)
    for adapter in lora.values():
        adapter["lora_b"] = torch.randn(
            adapter["lora_b"].shape, generator=generator, device=device,
            dtype=torch.float32) * b_scale
    return lora


def lora_param_count(config: LlamaConfig, rank: int = 16,
                     targets: Sequence[str] = DEFAULT_TARGETS) -> int:
    total = 0
    for target in targets:
        d_in, d_out = _PROJ_DIMS[target](config)
        total += config.n_layers * rank * (d_in + d_out)
    return total


def lora_rank(lora: Params) -> int:
    """The adapter's rank, read off the first target's A factor."""
    for adapter in lora.values():
        return int(adapter["lora_a"].shape[-1])
    raise LoraShapeError("adapter tree has no targets")


def validate_lora(lora: Params, *, config: LlamaConfig | None = None,
                  base: Params | None = None, rank: int | None = None,
                  targets: Sequence[str] | None = None) -> int:
    """Validate an adapter tree's internal consistency and, when
    ``config``/``base``/``rank``/``targets`` are given, its agreement
    with them. Returns the adapter's rank. Raises :class:`LoraShapeError`
    on any mismatch. Leaves may be torch tensors or numpy arrays (an
    artifact read by ``serving.adapters.load_adapter``)."""
    if not lora:
        raise LoraShapeError("adapter tree has no targets")
    seen_rank = None
    for target, adapter in lora.items():
        for key in ("lora_a", "lora_b", "scaling"):
            if key not in adapter:
                raise LoraShapeError(
                    f"adapter target '{target}' is missing '{key}'")
        a, b, scaling = (adapter["lora_a"], adapter["lora_b"],
                         adapter["scaling"])
        if a.ndim != 3 or b.ndim != 3 or scaling.ndim != 1:
            raise LoraShapeError(
                f"adapter target '{target}' has wrong ranks: lora_a "
                f"{tuple(a.shape)}, lora_b {tuple(b.shape)}, scaling "
                f"{tuple(scaling.shape)} (want [L, in, r], [L, r, out], [L])")
        layers, d_in, r = a.shape
        if b.shape[0] != layers or scaling.shape[0] != layers:
            raise LoraShapeError(
                f"adapter target '{target}' layer counts disagree: "
                f"lora_a {layers}, lora_b {b.shape[0]}, "
                f"scaling {scaling.shape[0]}")
        if b.shape[1] != r:
            raise LoraShapeError(
                f"adapter target '{target}' rank disagrees between "
                f"factors: lora_a rank {r}, lora_b rank {b.shape[1]}")
        if seen_rank is None:
            seen_rank = r
        elif r != seen_rank:
            raise LoraShapeError(
                f"adapter target '{target}' rank {r} != rank {seen_rank} "
                f"of the other targets")
        if targets is not None and target not in targets:
            raise LoraShapeError(
                f"adapter target '{target}' not in the allowed targets "
                f"{tuple(targets)}")
        if config is not None:
            if target not in _PROJ_DIMS:
                raise LoraShapeError(f"unknown lora target '{target}'")
            want_in, want_out = _PROJ_DIMS[target](config)
            if layers != config.n_layers or d_in != want_in \
                    or b.shape[2] != want_out:
                raise LoraShapeError(
                    f"adapter target '{target}' shape "
                    f"[{layers}, {d_in}, {r}]x[{b.shape[0]}, {b.shape[1]}, "
                    f"{b.shape[2]}] does not fit the config "
                    f"([{config.n_layers}, {want_in}, r]x"
                    f"[{config.n_layers}, r, {want_out}])")
        if base is not None:
            base_layers = base.get("layers", {})
            if target not in base_layers:
                raise LoraShapeError(
                    f"adapter target '{target}' has no base projection")
            bw = base_layers[target]
            if tuple(bw.shape) != (layers, d_in, b.shape[2]):
                raise LoraShapeError(
                    f"adapter target '{target}' delta shape "
                    f"[{layers}, {d_in}, {b.shape[2]}] does not match "
                    f"base weight shape {tuple(bw.shape)}")
    if rank is not None and seen_rank != rank:
        raise LoraShapeError(
            f"adapter rank {seen_rank} != required rank {rank}")
    return int(seen_rank)


@torch.no_grad()
def merge_lora(params: Params, lora: Params) -> Params:
    """Fold adapters into the base weights (for serving without LoRA
    math): each adapted ``[L, in, out]`` weight becomes ``base + A @ B *
    scaling``, added in float32 and cast back to the base dtype, one
    layer at a time (the float32 temporaries stay one layer's size).
    Validates rank/shape agreement first; the result shares every
    unadapted tensor with ``params``."""
    validate_lora(lora, base=params)
    merged = dict(params)
    layers = dict(params["layers"])
    for target, adapter in lora.items():
        base = layers[target]
        out = torch.empty_like(base)
        for layer in range(base.shape[0]):
            a = adapter["lora_a"][layer].to(base.device, torch.float32)
            b = adapter["lora_b"][layer].to(base.device, torch.float32)
            scale = adapter["scaling"][layer].to(base.device, torch.float32)
            out[layer] = (base[layer].float() + (a @ b) * scale).to(base.dtype)
        layers[target] = out
    merged["layers"] = layers
    return merged
