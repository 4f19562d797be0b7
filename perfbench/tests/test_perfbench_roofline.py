"""The yardstick's arithmetic, pinned to the kernel table's bounds: paged
decode at Llama-3-8B's attention widths (4 slots, page 128, max_len
2048, bf16) and the training flash kernels at B 4 x S 2048 x 32 heads x
D 64, causal."""

import pytest

import roofline


def _decode_bound_ms(positions):
    live = sum(p + 1 for p in positions)
    n_bytes = roofline.paged_decode_bytes(live, 4, 32, 8, 128, 2048 // 128,
                                          2)
    return roofline.bound_ms(n_bytes, roofline.paged_decode_ops(live, 32,
                                                                128))


@pytest.mark.parametrize("positions, want", [
    ((1, 700, 1300, 2047), 0.00497),
    ((600, 436, 200, 700), 0.00239),
])
def test_paged_decode_bound_matches_the_kernel_table(positions, want):
    bound, by = _decode_bound_ms(positions)
    assert by == "bytes"
    assert round(bound, 5) == want


def test_training_flash_bounds_match_the_kernel_table():
    b, s, h, hkv, d = 4, 2048, 32, 8, 64
    pairs = roofline.attention_pairs(True, b, s, h)
    fwd, fwd_by = roofline.bound_ms(
        roofline.flash_fwd_bytes(b, s, h, hkv, d, 2),
        roofline.flash_fwd_ops(pairs, d))
    bwd, bwd_by = roofline.bound_ms(
        roofline.flash_bwd_bytes(b, s, h, hkv, d, 2),
        roofline.flash_bwd_ops(pairs, d))
    assert (round(fwd, 4), fwd_by) == (0.0695, "operations")
    assert (round(bwd, 4), bwd_by) == (0.1738, "operations")


def test_token_flops_count_the_published_sizes():
    mistral = {"vocab_size": 32768, "n_layers": 32, "embed_dim": 4096,
               "n_heads": 32, "n_kv_heads": 8, "head_dim": 128,
               "mlp_dim": 14336}
    # 7.25 B parameters, of which the embedding (134 M) is a lookup
    assert roofline.dense_matmul_params(mistral) == 7_113_539_584
    assert roofline.decode_token_flops(mistral, 0) == 2 * 7_113_539_584
    mixtral = dict(mistral, vocab_size=32000, n_layers=2, n_experts=8,
                   top_k=2)
    active = roofline.moe_active_matmul_params(mixtral)
    # attention 41.9 M + router 32 K + two experts' 352.3 M a layer, head
    assert active == 2 * (41_943_040 + 32_768 + 352_321_536) + 131_072_000
    assert roofline.train_token_flops(mixtral, 8192) == \
        6.0 * active + 3 * 4 * 128 * 32 * 8193 / 2 * 2
