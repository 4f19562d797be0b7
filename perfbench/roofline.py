"""The yardstick's arithmetic: published H100 peaks, the bytes and
operations a kernel's inputs need, and the FLOPs a served or trained token
needs. Counts follow the work, not whatever implements it, so a later
change to a kernel cannot move them.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, without
sparsity), which assume the card's full 700 W; a run states the card's
power limit beside every share it reports.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12           # HBM3
PEAK_FLOPS = {"bf16": 989e12,        # dense tensor-core bf16
              "f32": 67e12}          # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float, kind: str = "bf16"
            ) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the peak, and which of the two bounds
    it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(n_bytes: float, n_ops: float, kind: str = "bf16"
             ) -> tuple[float, str]:
    t, by = bound_s(n_bytes, n_ops, kind)
    return t * 1e3, by


def kv_bytes(tokens: int, kv_heads: int, head_dim: int, item) -> int:
    """Bytes of the k and v vectors of ``tokens`` positions: ``item``
    bytes an element, or "int8": 1 byte an element plus a 4-byte float32
    scale a (position, kv head)."""
    per_head = head_dim + 4 if item == "int8" else head_dim * item
    return 2 * tokens * kv_heads * per_head


def paged_decode_bytes(live_tokens: int, slots: int, heads: int,
                       kv_heads: int, head_dim: int, pages_per_slot: int,
                       item: int) -> int:
    """One paged-decode launch: each live position's k and v read once,
    q read and the output written once, the page table and the positions
    read once."""
    q_bytes = slots * heads * head_dim * item
    return (kv_bytes(live_tokens, kv_heads, head_dim, item) + 2 * q_bytes
            + slots * pages_per_slot * 4 + slots * 4)


def paged_decode_ops(live_tokens: int, heads: int, head_dim: int) -> int:
    """q.k and p.v over every live position of every query head."""
    return 4 * head_dim * heads * live_tokens


def attention_pairs(causal: bool, batch: int, seq: int, heads: int) -> int:
    """Unmasked (query, key) pairs of self-attention over all heads."""
    per_head = seq * (seq + 1) // 2 if causal else seq * seq
    return batch * heads * per_head


def flash_fwd_ops(pairs: int, head_dim: int) -> int:
    """The forward: q.k and p.v, 2 operations each, a pair."""
    return 4 * head_dim * pairs


def flash_bwd_ops(pairs: int, head_dim: int) -> int:
    """The backward: q.k recomputed, dV, dP, dQ and dK, 2 operations
    each, a pair."""
    return 10 * head_dim * pairs


def flash_fwd_bytes(batch: int, seq: int, heads: int, kv_heads: int,
                    head_dim: int, item: int) -> int:
    """Read q, k, v once, write o and the float32 lse once."""
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    return (2 * q + 2 * kv) * item + batch * heads * seq * 4


def flash_bwd_bytes(batch: int, seq: int, heads: int, kv_heads: int,
                    head_dim: int, item: int) -> int:
    """Read q, k, v, o, dO and the lse once; write dq, dk, dv once."""
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    return (4 * q + 4 * kv) * item + batch * heads * seq * 4


# -- a model's FLOPs a token --------------------------------------------------

def dense_matmul_params(c: dict) -> int:
    """Weights a token multiplies in a dense decoder (attention
    projections, the SwiGLU MLP, the output head); the embedding lookup
    is free."""
    e, h, kv, m = c["embed_dim"], c["n_heads"] * c["head_dim"], \
        c["n_kv_heads"] * c["head_dim"], c["mlp_dim"]
    per_layer = e * h + 2 * e * kv + h * e + 3 * e * m
    return c["n_layers"] * per_layer + c["vocab_size"] * e


def moe_active_matmul_params(c: dict) -> int:
    """Weights a token multiplies in a top-k MoE decoder: the attention
    projections, the router, ``top_k`` experts' SwiGLU, the output
    head."""
    e, h, kv, m = c["embed_dim"], c["n_heads"] * c["head_dim"], \
        c["n_kv_heads"] * c["head_dim"], c["mlp_dim"]
    per_layer = (e * h + 2 * e * kv + h * e + e * c["n_experts"]
                 + c["top_k"] * 3 * e * m)
    return c["n_layers"] * per_layer + c["vocab_size"] * e


def decode_token_flops(c: dict, context: int) -> int:
    """One decoded token attending ``context`` positions: 2 operations a
    matmul weight, and q.k plus p.v over the context in every layer."""
    attn = 4 * c["head_dim"] * c["n_heads"] * context * c["n_layers"]
    return 2 * dense_matmul_params(c) + attn


def train_token_flops(c: dict, seq: int) -> float:
    """Training FLOPs a token of a causal sequence of ``seq`` tokens,
    forward and backward (3x the forward) and no recomputation: 6 a
    matmul weight the token multiplies, and the causal attention's q.k
    and p.v over its (seq + 1) / 2 positions on average."""
    matmul = (moe_active_matmul_params(c) if c.get("n_experts")
              else dense_matmul_params(c))
    attn = 3 * 4 * c["head_dim"] * c["n_heads"] * (seq + 1) / 2 \
        * c["n_layers"]
    return 6.0 * matmul + attn
