"""A configuration file's published keys as the port's model config, and
its weights drawn on the device from the run's seed.

The mapping from a published ``config.json``'s keys to the port's
``LlamaConfig`` / ``MoEConfig`` fields is one table, so a later
configuration of either family is a data file alone. The weights are the
harness's input, handed alike to the port and to the plain reference:
each leaf is drawn whole in one call of a ``torch.Generator`` on the
device, in the dtype the model is served or trained in.
"""

from __future__ import annotations

import torch

# published key -> the port's field (head_dim falls back to hidden/heads)
_KEYS = {"vocab_size": "vocab_size", "num_hidden_layers": "n_layers",
         "hidden_size": "embed_dim", "num_attention_heads": "n_heads",
         "num_key_value_heads": "n_kv_heads", "intermediate_size": "mlp_dim",
         "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
         "tie_word_embeddings": "tie_embeddings"}
_MOE_KEYS = {"num_local_experts": "n_experts", "num_experts_per_tok": "top_k",
             "router_aux_loss_coef": "router_aux_weight"}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def sizes(config: dict) -> dict:
    """The port's field values of a configuration file (plain numbers):
    what the model config, the yardstick and the reference read."""
    out = {port: config[key] for key, port in _KEYS.items()}
    out["head_dim"] = int(
        config.get("head_dim") or config.get("assumed", {}).get("head_dim")
        or config["hidden_size"] // config["num_attention_heads"])
    if config.get("sliding_window"):
        raise ValueError(f"{config['name']}: a sliding window is not modelled "
                         "by the port's attention")
    if config["family"] == "moe":
        out.update({port: config[key] for key, port in _MOE_KEYS.items()})
        out["capacity_factor"] = config["departures"]["moe_capacity_factor"]
    out["dtype"] = config["torch_dtype"]
    return out


def port_config(config: dict, **overrides):
    """The configuration file as the port's ``LlamaConfig`` (family
    ``dense``) or ``MoEConfig`` (family ``moe``)."""
    from mlrun_tpu_torch.models.llama import LlamaConfig
    from mlrun_tpu_torch.models.moe import MoEConfig

    fields = sizes(config)
    fields.update(overrides)
    fields["dtype"] = _DTYPES[fields["dtype"]]
    cls = MoEConfig if config["family"] == "moe" else LlamaConfig
    return cls(**fields)


def leaf_shapes(s: dict) -> list:
    """(path, shape, fan_in or None for ones, dtype override) of every
    leaf, in the order they are drawn."""
    e, h, kv, m, L = (s["embed_dim"], s["n_heads"] * s["head_dim"],
                      s["n_kv_heads"] * s["head_dim"], s["mlp_dim"],
                      s["n_layers"])
    leaves = [(("embedding",), (s["vocab_size"], e), e, None),
              (("layers", "attn_norm_scale"), (L, e), None, None),
              (("layers", "wq"), (L, e, h), e, None),
              (("layers", "wk"), (L, e, kv), e, None),
              (("layers", "wv"), (L, e, kv), e, None),
              (("layers", "wo"), (L, h, e), h, None),
              (("layers", "mlp_norm_scale"), (L, e), None, None)]
    if s.get("n_experts"):
        n = s["n_experts"]
        leaves += [(("layers", "router"), (L, e, n), e, torch.float32),
                   (("layers", "experts_gate"), (L, n, e, m), e, None),
                   (("layers", "experts_up"), (L, n, e, m), e, None),
                   (("layers", "experts_down"), (L, n, m, e), m, None)]
    else:
        leaves += [(("layers", "w_gate"), (L, e, m), e, None),
                   (("layers", "w_up"), (L, e, m), e, None),
                   (("layers", "w_down"), (L, m, e), m, None)]
    leaves.append((("final_norm_scale",), (e,), None, None))
    if not s["tie_embeddings"]:
        leaves.append((("lm_head",), (e, s["vocab_size"]), e, None))
    return leaves


def draw_leaves(s: dict, seed: int, device):
    """Yield (path, tensor) for every leaf: normal with std fan_in**-0.5
    (one ``normal_`` call a leaf, from one generator on ``device`` seeded
    with ``seed``), norm scales 1. Drawing them again with the same seed
    gives the same bits, so a reference can rebuild a leaf it needs."""
    dtype = _DTYPES[s["dtype"]]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) % (1 << 63))
    for path, shape, fan_in, override in leaf_shapes(s):
        out = torch.empty(shape, dtype=override or dtype, device=device)
        if fan_in is None:
            out.fill_(1.0)
        else:
            out.normal_(0.0, fan_in ** -0.5, generator=generator)
        yield path, out


def make_params(s: dict, seed: int, device) -> dict:
    """The whole parameter tree in the port's layout (stacked ``[L, in,
    out]`` weights, the head ``[E, vocab]``)."""
    params: dict = {}
    for path, leaf in draw_leaves(s, seed, device):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params
