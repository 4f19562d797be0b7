"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on an NVIDIA GPU. Every test here is marked ``cuda`` and skips
without a CUDA device (a CUDA kernel has no CPU or interpret mode); the
CPU suite holds the plain versions against the JAX reference instead
(tests/test_torch_ops.py).

Run on a GPU machine (JAX need not be installed there, hence no conftest):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances (max abs error, kernel vs plain version on the same inputs):
float32 outputs and every lse 2e-5 — only the summation order differs
(int8 pages included: kernel and plain version dequantize with the same
one float32 multiply per element);
bf16 outputs 1.6e-2 — about two bf16 ulps at magnitude 1, since the two
round a differently ordered float32 sum. Flash backward gradients are
sums over up to thousands of O(1) terms of both signs, so their bound is
relative to the largest gradient or 1, whichever is larger (a gradient
that cancels to ~0 keeps the round-off of its O(1) terms): 1e-4 of it in
float32 and 1e-2 (about one bf16 ulp at the top magnitude) in bf16.
"""

import pytest
import torch

from mlrun_tpu_torch.ops import _build
from mlrun_tpu_torch.ops import attention as at
from mlrun_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
LSE_TOL = 2e-5
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SERVING_KERNELS = ("paged_decode", "flash_fwd_cached", "paged_prefill")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep,head_dim,page_size",
                         [(1, 64, 16), (2, 32, 16), (4, 128, 128),
                          (8, 128, 64)])
def test_paged_decode_kernel_matches_plain(dev, dtype, n_rep, head_dim,
                                           page_size):
    g = _gen(0)
    slots, hkv, pps = 4, 2, 6
    h = hkv * n_rep
    n_pages = slots * pps
    k = torch.randn((n_pages + 1, page_size, hkv, head_dim), generator=g,
                    device=dev).to(dtype)
    v = torch.randn(k.shape, generator=g, device=dev).to(dtype)
    q = torch.randn((slots, h, head_dim), generator=g, device=dev).to(dtype)
    table = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
    pos = torch.tensor([0, page_size - 1, page_size, pps * page_size - 1],
                       dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    for s in range(slots):
        live = int(pos[s]) // page_size + 1
        table[s, :live] = perm[s * pps:s * pps + live]
    out = pa._paged_decode_call(q, k, v, table, pos, page_size)
    ref = pa.paged_decode_reference(q, k, v, table, pos, page_size)
    assert out.dtype == dtype and out.shape == q.shape
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,q_offset,k_lo,hk", [
    (1, 64, 63, 0, 8), (70, 256, 0, 0, 2), (64, 300, 100, 64, 8),
    (200, 512, 300, 128, 2), (5, 128, 40, 33, 2)])
def test_flash_kernel_matches_plain(dev, dtype, s, m, q_offset, k_lo, hk):
    g = _gen(1)
    h, d = 8, 128
    q = torch.randn((2, s, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((2, m, hk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((2, m, hk, d), generator=g, device=dev).to(dtype)
    o, lse = at.flash_fwd_cached(q, k, v, q_offset, k_lo)
    o_ref, lse_ref = at.flash_fwd_cached_plain(q, k, v, q_offset, k_lo)
    assert o.dtype == dtype and lse.shape == (2, h, s)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_chunked_equals_unchunked_bitwise(dev, dtype):
    g = _gen(2)
    q = torch.randn((1, 300, 8, 64), generator=g, device=dev).to(dtype)
    k = torch.randn((1, 512, 2, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((1, 512, 2, 64), generator=g, device=dev).to(dtype)
    whole, whole_lse = at.flash_fwd_cached(q, k, v, 0)
    parts = [at.flash_fwd_cached(q[:, a:b].contiguous(), k, v, a)
             for a, b in ((0, 77), (77, 200), (200, 300))]
    assert torch.equal(whole, torch.cat([p[0] for p in parts], dim=1))
    assert torch.equal(whole_lse, torch.cat([p[1] for p in parts], dim=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,base,page_size", [(1, 16, 16), (37, 48, 16),
                                              (300, 256, 128)])
def test_paged_prefill_kernel_matches_plain(dev, dtype, s, base, page_size):
    g = _gen(3)
    h, hkv, d, pps = 8, 2, 128, 4
    k = torch.randn((9, page_size, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((9, page_size, hkv, d), generator=g, device=dev).to(dtype)
    q = torch.randn((s, h, d), generator=g, device=dev).to(dtype)
    ids = torch.full((pps,), -1, dtype=torch.int32, device=dev)
    n = -(-base // page_size)
    ids[:n] = torch.tensor([5, 0, 7, 2][:n], dtype=torch.int32)
    o, lse = pa._paged_prefill_call(q, k, v, ids, base, page_size)
    o_ref, lse_ref = pa.paged_prefill_reference(q, k, v, ids, base,
                                                page_size)
    assert o.dtype == torch.float32 and lse.shape == (s, h)
    # float32 outputs computed from the same input bits in both versions
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert _err(lse, lse_ref) <= LSE_TOL


def _int8_pages(g, n_pages, page_size, hkv, d, dev):
    from mlrun_tpu_torch.serving.llm import _quantize_kv

    out = []
    for _ in ("k", "v"):
        x = torch.randn((n_pages, page_size, hkv, d), generator=g,
                        device=dev)
        out.extend(_quantize_kv(x))
    return out                                   # k, k_scale, v, v_scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep,hkv,head_dim,page_size",
                         [(4, 1, 64, 16), (4, 8, 128, 128), (1, 8, 64, 16),
                          (8, 1, 128, 128)])
def test_paged_decode_int8_kernel_matches_plain(dev, dtype, n_rep, hkv,
                                                head_dim, page_size):
    g = _gen(20)
    slots, pps = 4, 6
    n_pages = slots * pps
    k, ks, v, vs = _int8_pages(g, n_pages + 1, page_size, hkv, head_dim, dev)
    q = torch.randn((slots, hkv * n_rep, head_dim), generator=g,
                    device=dev).to(dtype)
    table = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
    pos = torch.tensor([0, page_size - 1, page_size, pps * page_size - 1],
                       dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    for s in range(slots):
        live = int(pos[s]) // page_size + 1
        table[s, :live] = perm[s * pps:s * pps + live]
    before = _build.launch_counts()["paged_decode_int8"]
    out = pa._paged_decode_call(q, k, v, table, pos, page_size, k_scale=ks,
                                v_scale=vs)
    assert _build.launch_counts()["paged_decode_int8"] == before + 1
    ref = pa.paged_decode_reference(q, k, v, table, pos, page_size,
                                    k_scale=ks, v_scale=vs)
    assert out.dtype == dtype and out.shape == q.shape
    assert _err(out, ref) <= TOL[dtype]
    with pytest.raises(TypeError):       # int8 pages need their scales
        pa._paged_decode_call(q, k, v, table, pos, page_size)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,base,page_size,hkv,d", [
    (1, 16, 16, 1, 64), (37, 48, 16, 8, 128), (300, 256, 128, 8, 128),
    (64, 200, 128, 1, 64)])
def test_paged_prefill_int8_kernel_matches_plain(dev, dtype, s, base,
                                                 page_size, hkv, d):
    g = _gen(21)
    h, pps = hkv * 4, 4
    k, ks, v, vs = _int8_pages(g, 9, page_size, hkv, d, dev)
    q = torch.randn((s, h, d), generator=g, device=dev).to(dtype)
    ids = torch.full((pps,), -1, dtype=torch.int32, device=dev)
    n = -(-base // page_size)
    ids[:n] = torch.tensor([5, 0, 7, 2][:n], dtype=torch.int32)
    o, lse = pa._paged_prefill_call(q, k, v, ids, base, page_size,
                                    k_scale=ks, v_scale=vs)
    o_ref, lse_ref = pa.paged_prefill_reference(q, k, v, ids, base,
                                                page_size, ks, vs)
    assert o.dtype == torch.float32 and lse.shape == (s, h)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert _err(lse, lse_ref) <= LSE_TOL


def _verify_inputs(seed, dtype, int8, page_size=16, hkv=8, d=128):
    g = _gen(seed)
    slots, s, pps = 4, 5, 8
    h = hkv * 4
    n_pages = slots * pps
    if int8:
        k, ks, v, vs = _int8_pages(g, n_pages + 1, page_size, hkv, d, "cuda")
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k = torch.randn((n_pages + 1, page_size, hkv, d), generator=g,
                        device="cuda").to(dtype)
        v = torch.randn(k.shape, generator=g, device="cuda").to(dtype)
        scales = {}
    q = torch.randn((slots, s, h, d), generator=g, device="cuda").to(dtype)
    # base 0 (nothing behind the chunk), mid-page, a page boundary, deep
    base = torch.tensor([0, 21, 48, 8 * page_size - 5], dtype=torch.int32,
                        device="cuda")
    table = torch.full((slots, pps), -1, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=g, device="cuda").to(
        torch.int32)
    for r in range(slots):
        live = -(-int(base[r]) // page_size)
        table[r, :live] = perm[r * pps:r * pps + live]
    return q, k, v, table, base, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size,hkv,d", [(16, 8, 128), (128, 1, 64)])
def test_paged_verify_kernel_matches_plain(dev, dtype, int8, page_size, hkv,
                                           d):
    q, k, v, table, base, scales = _verify_inputs(22, dtype, int8,
                                                  page_size, hkv, d)
    name = "paged_verify_int8" if int8 else "paged_verify"
    before = _build.launch_counts()[name]
    o, lse = pa._paged_verify_call(q, k, v, table, base, page_size,
                                   **scales)
    assert _build.launch_counts()[name] == before + 1
    o_ref, lse_ref = pa.paged_verify_prefix_reference(q, k, v, table, base,
                                                      page_size, **scales)
    assert o.dtype == torch.float32 and lse.shape == (4, q.shape[2], 5)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert _err(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("int8", [False, True])
def test_single_slot_verify_equals_prefill_bitwise(dev, int8):
    """One verify block body serves both entry points: a one-slot verify
    over that slot's ids and base gives the prefill kernel's bits."""
    q, k, v, table, base, scales = _verify_inputs(23, torch.bfloat16, int8)
    for r in (1, 3):
        o, lse = pa._paged_verify_call(q[r:r + 1].contiguous(), k, v,
                                       table[r:r + 1].contiguous(),
                                       base[r:r + 1].contiguous(), 16,
                                       **scales)
        o1, lse1 = pa._paged_prefill_call(q[r], k, v, table[r],
                                          int(base[r]), 16, **scales)
        assert torch.equal(o[0], o1)
        assert torch.equal(lse[0], lse1.T)


# -- the split-K decode and the tensor-core prefix body: bit properties ------

def _decode_inputs(seed, dtype, int8, page_size, pos, n_rep=4, hkv=8, d=128,
                   pps=16):
    """Pages, q and a page table of distinct random pages for slots at
    ``pos``; int8 pools pass their scales."""
    g = _gen(seed)
    slots = len(pos)
    n_pages = slots * pps
    if int8:
        k, ks, v, vs = _int8_pages(g, n_pages + 1, page_size, hkv, d, "cuda")
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k = torch.randn((n_pages + 1, page_size, hkv, d), generator=g,
                        device="cuda").to(dtype)
        v = torch.randn(k.shape, generator=g, device="cuda").to(dtype)
        scales = {}
    q = torch.randn((slots, hkv * n_rep, d), generator=g,
                    device="cuda").to(dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=g, device="cuda").to(
        torch.int32)
    table = torch.full((slots, pps), -1, dtype=torch.int32, device="cuda")
    for r, p in enumerate(pos):
        live = p // page_size + 1
        table[r, :live] = perm[r * pps:r * pps + live]
    return q, k, v, table, pos_t, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_reruns_and_batch_are_bit_invariant(dev, dtype, int8):
    """Split-K over pages merges in a fixed order: two launches give the
    same bits, and every slot of a 4-slot launch gives the bits it gets
    decoded alone."""
    q, k, v, table, pos, scales = _decode_inputs(
        30, dtype, int8, 128, [1, 700, 1300, 2047])
    out = pa._paged_decode_call(q, k, v, table, pos, 128, **scales)
    again = pa._paged_decode_call(q, k, v, table, pos, 128, **scales)
    assert torch.equal(out, again)
    for r in range(4):
        alone = pa._paged_decode_call(
            q[r:r + 1].contiguous(), k, v, table[r:r + 1].contiguous(),
            pos[r:r + 1].contiguous(), 128, **scales)
        assert torch.equal(alone[0], out[r]), r
    ref = pa.paged_decode_reference(q, k, v, table, pos, 128, **scales)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [16, 128])
def test_paged_decode_at_the_last_position(dev, dtype, int8, page_size):
    """A slot whose current token is the last row of its last page (pos =
    pages_per_slot * page_size - 1), beside a short one."""
    pps = 8
    last = pps * page_size - 1
    q, k, v, table, pos, scales = _decode_inputs(
        31, dtype, int8, page_size, [last, 3], pps=pps)
    out = pa._paged_decode_call(q, k, v, table, pos, page_size, **scales)
    ref = pa.paged_decode_reference(q, k, v, table, pos, page_size,
                                    **scales)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_prefill_chunks_and_reruns_are_bitwise(dev, dtype, int8):
    """A row's (o, lse) bits depend only on the key tiles it visits: S 300
    equals chunks 0-77 / 77-200 / 200-300 over the same base (three chunks
    of the split-K merge), and a rerun gives the same bits."""
    g = _gen(32)
    h, hkv, d, page_size, pps, base = 32, 8, 128, 16, 32, 300
    if int8:
        k, ks, v, vs = _int8_pages(g, 40, page_size, hkv, d, dev)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k = torch.randn((40, page_size, hkv, d), generator=g,
                        device=dev).to(dtype)
        v = torch.randn(k.shape, generator=g, device=dev).to(dtype)
        scales = {}
    q = torch.randn((300, h, d), generator=g, device=dev).to(dtype)
    ids = torch.randperm(39, generator=g, device=dev)[:pps].to(torch.int32)
    ids[-(-base // page_size):] = -1
    o, lse = pa._paged_prefill_call(q, k, v, ids, base, page_size, **scales)
    o2, lse2 = pa._paged_prefill_call(q, k, v, ids, base, page_size,
                                      **scales)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    parts = [pa._paged_prefill_call(q[a:b].contiguous(), k, v, ids, base,
                                    page_size, **scales)
             for a, b in ((0, 77), (77, 200), (200, 300))]
    assert torch.equal(o, torch.cat([p[0] for p in parts]))
    assert torch.equal(lse, torch.cat([p[1] for p in parts]))
    o_ref, lse_ref = pa.paged_prefill_reference(q, k, v, ids, base,
                                                page_size, **scales)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert _err(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("spec_k", [1, 4, 7])
def test_paged_verify_at_each_k(dev, dtype, int8, spec_k):
    """Verify chunks of k + 1 rows a slot over 128-key split-K chunks,
    against the plain version; a rerun gives the same bits."""
    g = _gen(33)
    slots, hkv, n_rep, d, page_size, pps = 4, 8, 4, 128, 128, 16
    s = spec_k + 1
    n_pages = slots * pps
    if int8:
        k, ks, v, vs = _int8_pages(g, n_pages + 1, page_size, hkv, d, dev)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k = torch.randn((n_pages + 1, page_size, hkv, d), generator=g,
                        device=dev).to(dtype)
        v = torch.randn(k.shape, generator=g, device=dev).to(dtype)
        scales = {}
    q = torch.randn((slots, s, hkv * n_rep, d), generator=g,
                    device=dev).to(dtype)
    base = torch.tensor([600, 436, 200, 700], dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    table = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
    for r in range(slots):
        live = -(-(int(base[r]) + s) // page_size)
        table[r, :live] = perm[r * pps:r * pps + live]
    o, lse = pa._paged_verify_call(q, k, v, table, base, page_size, **scales)
    o2, lse2 = pa._paged_verify_call(q, k, v, table, base, page_size,
                                     **scales)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, lse_ref = pa.paged_verify_prefix_reference(q, k, v, table, base,
                                                      page_size, **scales)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert _err(lse, lse_ref) <= LSE_TOL


def test_paged_engine_int8_kernels_match_reference_engine(dev):
    """A tiny float32 model on an int8 pool, kernel engine vs reference
    engine: identical greedy tokens (cold and through a prefix hit), the
    int8 kernels launched and no gather tick on the kernel path."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(24), dev)
    shared = torch.randint(1, 512, (32,), generator=torch.Generator()
                           .manual_seed(25)).tolist()
    prompts = [shared + [7, 8, 9], shared + [11] * 12, list(range(1, 21))]
    outs = []
    for impl in ("kernel", "reference"):
        eng = PagedContinuousBatchingEngine(
            cfg, params, max_len=128, slots=2, page_size=16,
            prefill_buckets=(16, 32, 64), attention_impl=impl,
            kv_dtype="int8", device=dev)
        _build.reset_launch_counts()
        try:
            outs.append([eng.generate(p, 6)[0] for p in prompts])
            stats = eng.stats
        finally:
            eng.stop()
        counts = _build.launch_counts()
        if impl == "kernel":
            assert counts["paged_decode_int8"] > 0
            assert counts["paged_prefill_int8"] > 0
            assert counts["paged_decode"] == counts["paged_prefill"] == 0
            assert stats["attn_gather_ticks"] == 0
        else:
            assert not any(counts.values())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_spec_engine_verify_kernel_on_and_off_identical(dev, kv_dtype):
    """Speculation on the kernel path: the verify kernel runs every round
    and the streams equal the spec-off streams, with a permutation pair
    (exact by construction) and with random weights (the tiny model's
    top-2 margins are far above the float32 noise)."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    perm_cfg = llama.tiny_llama(dtype=torch.float32, vocab_size=64,
                                tie_embeddings=False)
    target_perm, draft_perm = llama.permutation_pair(64, overlap=0.7)
    rand_cfg = llama.tiny_llama(dtype=torch.float32)
    pairs = [
        (perm_cfg, llama.init_permutation_params(perm_cfg, target_perm,
                                                 device=dev),
         llama.init_permutation_params(perm_cfg, draft_perm, device=dev)),
        (rand_cfg, llama.init_params(rand_cfg, _gen(26), dev),
         llama.init_params(rand_cfg, _gen(27), dev)),
    ]
    verify = "paged_verify_int8" if kv_dtype == "int8" else "paged_verify"
    for cfg, target, draft in pairs:
        prompts = [[1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2, 9, 9, 4, 1, 2],
                   [5, 3, 2]]
        outs = []
        for spec in (None, {"enabled": True, "k": 4, "draft_config": cfg,
                            "draft_params": draft}):
            eng = PagedContinuousBatchingEngine(
                cfg, target, max_len=64, slots=2, page_size=16,
                prefill_buckets=(16, 32), kv_dtype=kv_dtype,
                speculative=spec, device=dev)
            _build.reset_launch_counts()
            try:
                outs.append([eng.generate(p, 12)[0] for p in prompts])
                stats = eng.stats
            finally:
                eng.stop()
        # one row at a time: one verify dispatch (one launch a layer) per
        # speculative round
        assert stats["spec_rounds"] > 0 and stats["attn_gather_ticks"] == 0
        assert _build.launch_counts()[verify] == \
            cfg.n_layers * stats["spec_rounds"]
        assert outs[0] == outs[1]


def test_launches_are_counted_and_bad_inputs_refused(dev):
    q = torch.randn((1, 8, 4, 64), device=dev)
    k = torch.randn((1, 32, 2, 64), device=dev)
    before = _build.launch_counts()["flash_fwd_cached"]
    at.flash_fwd_cached(q, k, k, 0)
    assert _build.launch_counts()["flash_fwd_cached"] == before + 1
    with pytest.raises(TypeError):
        at.flash_fwd_cached(q.half(), k.half(), k.half(), 0)
    with pytest.raises(ValueError):
        at.flash_fwd_cached(q.transpose(1, 2), k, k, 0)
    with pytest.raises(ValueError):
        at.flash_fwd_cached(q, k.cpu(), k.cpu(), 0)
    assert _build.launch_counts()["flash_fwd_cached"] == before + 1


def test_paged_engine_kernels_match_reference_engine(dev):
    """A tiny float32 model served on the GPU by the kernel engine and the
    reference engine: identical greedy tokens, every kernel launched."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(4), dev)
    shared = torch.randint(1, 512, (32,), generator=torch.Generator()
                           .manual_seed(5)).tolist()
    prompts = [shared + [7, 8, 9], shared + [11] * 12, list(range(1, 21))]
    outs = []
    for impl in ("kernel", "reference"):
        eng = PagedContinuousBatchingEngine(
            cfg, params, max_len=128, slots=2, page_size=16,
            prefill_buckets=(16, 32, 64), attention_impl=impl, device=dev)
        _build.reset_launch_counts()
        try:
            outs.append([eng.generate(p, 6)[0] for p in prompts])
            stats = eng.stats
        finally:
            eng.stop()
        counts = _build.launch_counts()
        if impl == "kernel":
            assert all(counts[name] > 0 for name in SERVING_KERNELS)
            assert counts["flash_fwd"] == counts["flash_bwd"] == 0
            assert stats["prefill_gather_admissions"] == 0
            assert stats["prefill_kernel_chunks"] > 0
        else:
            assert not any(_build.launch_counts().values())
    assert outs[0] == outs[1]


def test_kernel_engine_chunked_prefill_is_token_identical(dev):
    """Chunked prefill on the kernel path (16-token chunks, flash over
    q_offset > 0) gives the same greedy tokens as whole-prompt prefill —
    the flash kernel's chunk-invariance carried end to end."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(6), dev)
    prompt = list(range(3, 60))
    outs = []
    for chunk in (0, 16):
        eng = PagedContinuousBatchingEngine(
            cfg, params, max_len=128, slots=2, page_size=16,
            prefill_buckets=(16, 32, 64), prefill_chunk=chunk, device=dev)
        try:
            outs.append(eng.generate(prompt, 8)[0])
            assert eng.stats["prefill_impl"] == "flash"
        finally:
            eng.stop()
    assert outs[0] == outs[1]


# -- training flash: forward and backward kernels -----------------------------

TRAIN_CASES = [
    # (S, H, Hkv, D, causal); S not a multiple of 64 in most
    (70, 4, 2, 64, True), (70, 4, 2, 64, False), (200, 8, 2, 32, True),
    (130, 4, 4, 128, False), (256, 8, 1, 128, True), (1, 2, 1, 64, True),
    # ViT-B/16 at 224 (197 tokens) and BERT-base at 512: 12 heads, no
    # GQA, D 64, not causal
    (197, 12, 12, 64, False), (512, 12, 12, 64, False)]


def _train_inputs(seed, s, h, hkv, d, dtype, b=2):
    g = _gen(seed)
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,hkv,d,causal", TRAIN_CASES)
def test_train_flash_fwd_kernel_matches_plain(dev, dtype, s, h, hkv, d,
                                              causal):
    q, k, v, _ = _train_inputs(7, s, h, hkv, d, dtype)
    o, lse = at.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = at.flash_fwd_plain(q, k, v, causal)
    assert o.dtype == dtype and lse.shape == (2, h, s)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,hkv,d,causal", TRAIN_CASES)
def test_train_flash_bwd_kernel_matches_plain(dev, dtype, s, h, hkv, d,
                                              causal):
    q, k, v, do = _train_inputs(8, s, h, hkv, d, dtype)
    o, lse = at.flash_fwd(q, k, v, causal)
    grads = at.flash_bwd(q, k, v, o, lse, do, causal)
    refs = at.flash_bwd_plain(q, k, v, o, lse, do, causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype and got.shape == ref.shape, name
        scale = max(float(ref.float().abs().max()), 1.0)
        assert _err(got, ref) <= GRAD_RTOL[dtype] * scale, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_flash_bwd_kernel_is_deterministic(dev, dtype):
    """No atomics: two backward launches give the same bits."""
    q, k, v, do = _train_inputs(9, 300, 8, 2, 64, dtype)
    o, lse = at.flash_fwd(q, k, v, True)
    first = at.flash_bwd(q, k, v, o, lse, do, True)
    second = at.flash_bwd(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_autograd_launches_kernels(dev):
    q, k, v, do = _train_inputs(10, 96, 4, 2, 64, torch.float32)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    _build.reset_launch_counts()
    o = at.flash_attention_mlt(q, k, v, True)
    o.backward(do)
    counts = _build.launch_counts()
    assert counts["flash_fwd"] == 1 and counts["flash_bwd"] == 1
    ref = at.attention_reference(q, k, v, causal=True)
    grads = torch.autograd.grad(ref, (q, k, v), do)
    for got, want in zip((q.grad, k.grad, v.grad), grads):
        assert _err(got, want) <= 1e-4 * max(float(want.abs().max()), 1.0)
    with pytest.raises(ValueError):
        at.flash_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                     torch.zeros(1, device=dev), do, True)


@pytest.mark.parametrize("policy,fwd_per_layer", [
    (None, 1), ("nothing", 2), ("save_attn", 1), ("dots", 2)])
def test_train_launch_counts_per_remat_policy(dev, policy, fwd_per_layer):
    """One forward launch per layer per pass, one more under a policy
    that recomputes the attention; one backward launch per layer."""
    import dataclasses

    from mlrun_tpu_torch.models import llama

    cfg = llama.tiny_llama(dtype=torch.float32, remat=policy is not None,
                           remat_policy=policy or "nothing")
    params = llama.init_params(cfg, _gen(11), dev)
    for leaf in (params["embedding"], *params["layers"].values()):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                           generator=_gen(12))
    _build.reset_launch_counts()
    loss, _ = llama.loss_fn(cfg, params, tokens, tokens, loss_chunk=32)
    loss.backward()
    counts = _build.launch_counts()
    assert counts["flash_fwd"] == fwd_per_layer * cfg.n_layers
    assert counts["flash_bwd"] == cfg.n_layers
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref_loss, _ = llama.loss_fn(ref_cfg, params, tokens, tokens,
                                loss_chunk=32)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5


def test_trainer_kernel_path_matches_reference_path(dev):
    """Three float32 steps of the tiny model through Trainer.fit on the
    kernel path and on the reference attention: the same losses and
    grad norms (1e-5 relative), every step through both kernels."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.data import synthetic_token_stream

    runs = {}
    for impl in ("auto", "reference"):
        trainer = Trainer(llama.tiny_llama(dtype=torch.float32,
                                           attention_impl=impl),
                          TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=3), device=dev)
        trainer.init(0)
        trainer.warmup(4, 128)
        _build.reset_launch_counts()
        trainer.fit(synthetic_token_stream(4, 128, 512, seed=1), 3,
                    log_every=1)
        runs[impl] = (trainer.metrics_history, _build.launch_counts())
    (hist, counts), (ref_hist, ref_counts) = runs["auto"], runs["reference"]
    assert counts["flash_fwd"] == counts["flash_bwd"] == 3 * 2
    # the optimizer's kernels run on both paths: one norm and one update a
    # step; the reference attention launches no other kernel
    for got in (counts, ref_counts):
        assert got["grad_sqnorm"] == got["adamw"] == 3
    assert not any(v for k, v in ref_counts.items()
                   if k not in ("grad_sqnorm", "adamw"))
    for a, b in zip(hist, ref_hist):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), key


# -- the v1 flash entry point and RMSNorm -------------------------------------

V1_CASES = [
    # (Sq, Sk, H, Hk, D): Sq != Sk both ways, lengths not multiples of the
    # 64-row tiles, kv at q's head count (the v1 signature) and at fewer
    (1000, 777, 4, 4, 128), (777, 1000, 4, 4, 64), (200, 150, 2, 2, 64),
    (256, 256, 4, 2, 128), (1, 65, 2, 2, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,h,hk,d", V1_CASES)
def test_flash_v1_kernel_matches_plain(dev, dtype, causal, sq, sk, h, hk, d):
    g = _gen(21)
    q = torch.randn((2, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((2, sk, hk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((2, sk, hk, d), generator=g, device=dev).to(dtype)
    before = _build.launch_counts()["flash_v1"]
    o, lse = at._flash_fwd(q, k, v, causal=causal)
    assert _build.launch_counts()["flash_v1"] == before + 1
    o_ref, lse_ref = at.flash_fwd_plain(q, k, v, causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.shape == (2, h, sq)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= LSE_TOL


def test_flash_v1_refuses_head_dims_without_a_kernel(dev):
    from mlrun_tpu_torch.ops.paged_attention import KernelUnavailableError

    q = torch.randn((1, 8, 2, 96), device=dev)
    before = _build.launch_counts()["flash_v1"]
    with pytest.raises(KernelUnavailableError, match="head_dim 96"):
        at._flash_fwd(q, q, q)
    with pytest.raises(TypeError):
        at._flash_fwd(q[..., :64].half(), q[..., :64].half(),
                      q[..., :64].half())
    assert _build.launch_counts()["flash_v1"] == before


def _ulp(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """One ulp of each element of x in a float format with that many
    explicit mantissa bits (7 for bf16, 10 for f16)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mantissa_bits)


@pytest.mark.parametrize("dtype,scale_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32)])
@pytest.mark.parametrize("shape", [(4, 2048, 64), (1000, 4100), (3, 7),
                                   (5, 4096), (257, 33)])
def test_rms_norm_kernel_matches_plain(dev, dtype, scale_dtype, shape):
    """Any row count and any F (rows of 4100 bf16 values start off the
    16-byte boundary every other row): float32 out within 2e-6 relative of
    the plain version, 16-bit out within one ulp of it (rsqrtf may sit an
    ulp from torch.rsqrt, and the sums run in another order)."""
    from mlrun_tpu_torch.ops import norms

    g = _gen(22)
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    scale = torch.randn(shape[-1:], generator=g, device=dev).to(scale_dtype)
    before = _build.launch_counts()["rms_norm"]
    out = norms.rms_norm_pallas(x, scale, 1e-5, block_rows=128)
    assert _build.launch_counts()["rms_norm"] == before + 1
    ref = norms.rms_norm_pallas_plain(x, scale, 1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert bool((diff <= 2e-6 * ref.abs()).all()), float(diff.max())
    else:
        bits = 7 if dtype == torch.bfloat16 else 10
        assert bool((diff <= _ulp(ref, bits)).all()), float(diff.max())


def test_rms_norm_kernel_refuses_bad_inputs(dev):
    from mlrun_tpu_torch.ops import norms

    x = torch.randn((4, 64), device=dev, dtype=torch.bfloat16)
    before = _build.launch_counts()["rms_norm"]
    with pytest.raises(TypeError):
        norms.rms_norm_pallas(x, torch.ones(64, device=dev,
                                            dtype=torch.float16))
    with pytest.raises(ValueError):
        norms.rms_norm_pallas(x, torch.ones(32, device=dev))
    with pytest.raises(ValueError):
        norms.rms_norm_pallas(x, torch.ones(64))
    assert _build.launch_counts()["rms_norm"] == before
    # a strided x is made contiguous first
    out = norms.rms_norm_pallas(x.t().contiguous().t(), torch.ones(64,
                                                                   device=dev))
    assert torch.equal(out, norms.rms_norm_pallas(x, torch.ones(64,
                                                                device=dev)))


# -- the fused AdamW (csrc/adamw.cu) ------------------------------------------------

def _adamw_tree(seed: int):
    """Params of every case the two kernels walk: bf16 leaves of 1 element,
    sizes that are not a multiple of the 8-element vector, several 2048-
    element tiles, whole tiles, a leaf 2 bytes off the 16-byte boundary
    (element-by-element path), a float32 leaf and a bf16 leaf whose
    gradient is float32. Returns (params, the gradient dtypes)."""
    g = _gen(seed)

    def normal(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(
            dtype)

    params = {"a": normal(1), "b": normal(4097), "c": normal(3, 1003),
              "d": normal(70001), "e": normal(64, 2048),
              "f": normal(4099, dtype=torch.float32), "g": normal(5000),
              "h": normal(3002)[1:]}
    grad_dtypes = {key: torch.float32 if key == "g" else leaf.dtype
                   for key, leaf in params.items()}
    return params, grad_dtypes


def _adamw_grads(params, grad_dtypes, seed: int, scale: float) -> list:
    from mlrun_tpu_torch.training.train import tree_leaves

    g = _gen(seed)
    return tree_leaves({key: (torch.randn(leaf.shape, generator=g,
                                          device="cuda") * scale).to(
        grad_dtypes[key]) for key, leaf in params.items()})


def _clone_state(params, state):
    from mlrun_tpu_torch.training.train import AdamWState, tree_map

    clone = lambda t: t.clone()  # noqa: E731
    return tree_map(clone, params), AdamWState(
        state.count, tree_map(clone, state.mu), tree_map(clone, state.nu))


@pytest.mark.parametrize("clip,weight_decay,grad_scale", [
    (0.0, 0.0, 1.0), (0.0, 0.1, 1.0), (1.0, 0.1, 1e-5), (1.0, 0.0, 1.0),
    (1.0, 0.1, 1.0)])
def test_fused_adamw_matches_the_plain_loop(dev, clip, weight_decay,
                                            grad_scale):
    """Three updates through the kernels (CUDA leaves) against the plain
    loop on copies of the same state, clip off, on and not triggered (its
    norm about 3e-3), on and triggered (about 300):
    - given the kernels' own clip scale, the plain loop's mu, nu and params
      are the kernels' bit for bit, in every case;
    - the norm is within 1e-6 relative of ``global_norm``'s (another
      summation order);
    - against the plain loop with its own norm: the same bits where the
      clip is off or not triggered. Where it is triggered, its divisor
      differs by that norm's rounding, and a float32 difference of an ulp
      or two moves a stored bf16 value where it lies that close to a
      rounding boundary, or where a moment cancels near 0; so there each
      leaf's difference is held to 1e-3 of its norm (a bf16 ulp is 3.9e-3
      of a value)."""
    from mlrun_tpu_torch.training.train import (
        AdamW,
        _clip_scale,
        global_norm,
        tree_leaves,
    )

    params, grad_dtypes = _adamw_tree(30)
    opt = AdamW(lambda count: 1e-3 * (count + 1), b2=0.95,
                weight_decay=weight_decay, grad_clip=clip)
    state = opt.init(params)
    same = _clone_state(params, state)    # plain loop, the kernels' scale
    own = _clone_state(params, state)     # plain loop, its own norm
    for step in range(3):
        grads = _adamw_grads(params, grad_dtypes, 31 + step, grad_scale)
        before = _build.launch_counts()
        g_norm = opt.update(grads, state, params)
        after = _build.launch_counts()
        assert after["adamw"] == before["adamw"] + 1
        assert after["grad_sqnorm"] == before["grad_sqnorm"] + 1
        hyper = opt._constants(step)
        for (tree, st), norm in ((same, g_norm),
                                 (own, global_norm(grads))):
            opt._apply_plain(grads, tree_leaves(tree), tree_leaves(st.mu),
                             tree_leaves(st.nu), *hyper,
                             _clip_scale(norm, clip) if clip else None)
        ref_norm = float(global_norm(grads))
        assert abs(float(g_norm) - ref_norm) <= 1e-6 * ref_norm
        triggered = bool(clip) and ref_norm >= clip
        assert triggered == (bool(clip) and grad_scale == 1.0)
        got = [tree_leaves(t) for t in (params, state.mu, state.nu)]
        for other, exact in ((same, True), (own, not triggered)):
            want = [tree_leaves(t) for t in (other[0], other[1].mu,
                                             other[1].nu)]
            for a_list, b_list in zip(got, want):
                for a, b in zip(a_list, b_list):
                    if exact:
                        assert torch.equal(a, b), (step, float(
                            (a.float() - b.float()).abs().max()))
                    else:
                        gap = torch.linalg.vector_norm(a.float() - b.float())
                        assert gap <= 1e-3 * torch.linalg.vector_norm(
                            b.float()), step
    assert state.count == 3


def test_fused_adamw_syncs_nothing_and_counts_its_leaves(dev):
    """The fused update under ``set_sync_debug_mode("error")`` (no host
    sync), one launch of each kernel an update and none of any other
    kernel, and the ``train.optimizer`` span's ``fused_leaves`` /
    ``fused_elements`` (every leaf's elements)."""
    from mlrun_tpu_torch.obs import tracing
    from mlrun_tpu_torch.training.train import AdamW, tree_leaves

    params, grad_dtypes = _adamw_tree(40)
    grads = _adamw_grads(params, grad_dtypes, 41, 1.0)
    opt = AdamW(lambda count: 1e-3, weight_decay=0.1, grad_clip=1.0)
    state = opt.init(params)
    opt.update(grads, state, params)      # loads the kernels
    torch.cuda.synchronize()
    tracer = tracing.get_tracer()
    tracer.clear()
    tracer.configure(phases=True)
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            opt.update(grads, state, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        tracer.configure(phases=False)
    counts = _build.launch_counts()
    torch.cuda.synchronize()
    spans = tracer.spans(name="train.optimizer")
    tracer.clear()
    assert counts == {**dict.fromkeys(counts, 0), "grad_sqnorm": 3,
                      "adamw": 3}
    leaves = tree_leaves(params)
    assert len(spans) == 3
    for span in spans:
        assert span.attrs["fused_leaves"] == len(leaves) == 8
        assert span.attrs["fused_elements"] == sum(p.numel() for p in leaves)
        assert span.attrs["device_ms"] > 0


def test_fused_adamw_refuses_leaves_it_does_not_take(dev):
    from mlrun_tpu_torch.ops import adamw as fused_adamw
    from mlrun_tpu_torch.training.train import AdamW

    opt = AdamW(lambda count: 1e-3, grad_clip=1.0)
    half = {"w": torch.zeros(64, device=dev, dtype=torch.float16)}
    mixed = {"a": torch.zeros(64, device=dev), "b": torch.zeros(64)}
    before = _build.launch_counts()
    with pytest.raises(TypeError):
        opt.update([torch.ones_like(half["w"])], opt.init(half), half)
    with pytest.raises(ValueError):
        opt.update([torch.ones_like(mixed["a"]), torch.ones_like(
            mixed["b"])], opt.init(mixed), mixed)
    p = torch.zeros((8, 8), device=dev).t()
    with pytest.raises(ValueError):
        fused_adamw.check_leaves([p], [torch.ones_like(p)],
                                 [torch.zeros(8, 8, device=dev)],
                                 [torch.zeros(8, 8, device=dev)])
    assert _build.launch_counts() == before


# -- the dense serving path ----------------------------------------------------

def test_llm_engine_flash_prefill_matches_reference_engine(dev):
    """LLMEngine on the GPU: the cached flash kernel runs every prefill
    (one launch a layer), decode stays dense, and the greedy tokens equal
    a reference-attention engine's."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.llm import LLMEngine

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(7), dev)
    prompts = [list(range(3, 40)), list(range(5, 69))]
    outs = []
    for impl in ("auto", "reference"):
        eng = LLMEngine(cfg, params, max_len=128, prefill_buckets=(32, 64),
                        attention_impl=impl, device=dev)
        _build.reset_launch_counts()
        outs.append([eng.generate(p, max_new_tokens=34)[0] for p in prompts])
        counts = _build.launch_counts()
        flash = 2 * cfg.n_layers if impl == "auto" else 0
        assert counts == {**dict.fromkeys(counts, 0),
                          "flash_fwd_cached": flash}
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_dense_engine_chunk_resume_kernels(dev, kv_dtype):
    """The dense ContinuousBatchingEngine on the GPU with 16-token chunks:
    every chunk (q_offset > 0 on a resume) launches the cached flash
    kernel once a layer, no paged kernel runs, and the tokens equal the
    whole-prompt prefill's and the reference-attention engine's."""
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.llm_batch import ContinuousBatchingEngine

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(8), dev)
    prompts = [list(range(3, 60)), list(range(100, 120))]
    outs = []
    for impl, chunk in (("auto", 16), ("auto", 0), ("reference", 16)):
        eng = ContinuousBatchingEngine(
            cfg, params, max_len=128, slots=2, prefill_buckets=(16, 32, 64),
            prefill_chunk=chunk, kv_dtype=kv_dtype, attention_impl=impl,
            device=dev)
        _build.reset_launch_counts()
        try:
            futures = [eng.submit(p, 8) for p in prompts]
            outs.append([f.result(timeout=300)[0] for f in futures])
            stats = eng.stats
        finally:
            eng.stop()
        counts = _build.launch_counts()
        flash = cfg.n_layers * stats["prefill_chunks"] if impl == "auto" \
            else 0
        assert counts == {**dict.fromkeys(counts, 0),
                          "flash_fwd_cached": flash}
        if chunk:
            assert stats["prefill_chunks"] == 4 + 2   # 57 and 20 tokens
    assert outs[0] == outs[1] == outs[2]


# -- the bf16 tensor-core flash kernels at more shapes ------------------------
# (bf16 runs csrc/flash_fwd_tc.cu and csrc/flash_bwd_tc.cu; float32 the FMA
# kernels the tests above also cover)

TC_CACHED_CASES = [
    # (B, S, M, H, Hk, D, q_offset, k_lo): ragged S and M, k_lo off the
    # 64-key grid, kv at q's head count, D 32, one row over a long cache
    (2, 77, 333, 8, 8, 32, 200, 0), (1, 130, 500, 4, 1, 64, 300, 37),
    (2, 65, 129, 4, 2, 128, 64, 63), (1, 1, 1000, 8, 2, 128, 999, 500),
    (3, 200, 200, 2, 2, 64, 0, 0)]


@pytest.mark.parametrize("b,s,m,h,hk,d,q_offset,k_lo", TC_CACHED_CASES)
def test_tc_flash_cached_bf16_matches_plain(dev, b, s, m, h, hk, d, q_offset,
                                            k_lo):
    g = _gen(31)
    q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, m, hk, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, m, hk, d), generator=g, device=dev).bfloat16()
    o, lse = at.flash_fwd_cached(q, k, v, q_offset, k_lo)
    o_ref, lse_ref = at.flash_fwd_cached_plain(q, k, v, q_offset, k_lo)
    assert o.dtype == torch.bfloat16 and lse.shape == (b, h, s)
    assert _err(o, o_ref) <= TOL[torch.bfloat16]
    assert _err(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,h,hk,d", [
    (100, 333, 4, 4, 32), (333, 100, 8, 2, 64), (129, 191, 4, 1, 128)])
def test_tc_flash_fwd_bf16_sq_ne_sk_matches_plain(dev, causal, sq, sk, h, hk,
                                                  d):
    g = _gen(32)
    q = torch.randn((2, sq, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((2, sk, hk, d), generator=g, device=dev).bfloat16()
    v = torch.randn((2, sk, hk, d), generator=g, device=dev).bfloat16()
    o, lse = at._flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = at.flash_fwd_plain(q, k, v, causal)
    assert _err(o, o_ref) <= TOL[torch.bfloat16]
    assert _err(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("d", [32, 128])
def test_tc_flash_cached_bf16_chunked_equals_unchunked_bitwise(dev, d):
    g = _gen(33)
    q = torch.randn((1, 300, 8, d), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 512, 2, d), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 512, 2, d), generator=g, device=dev).bfloat16()
    whole, whole_lse = at.flash_fwd_cached(q, k, v, 0, 37)
    parts = [at.flash_fwd_cached(q[:, a:b].contiguous(), k, v, a, 37)
             for a, b in ((37, 77), (77, 200), (200, 300))]
    assert torch.equal(whole[:, 37:], torch.cat([p[0] for p in parts], 1))
    assert torch.equal(whole_lse[..., 37:],
                       torch.cat([p[1] for p in parts], dim=2))


@pytest.mark.parametrize("s,h,hkv,d,causal", [
    (333, 4, 4, 128, True), (200, 8, 2, 128, False), (97, 4, 1, 32, True),
    (130, 2, 2, 64, False)])
def test_tc_flash_bwd_bf16_within_half_ulp(dev, s, h, hkv, d, causal):
    """bf16 gradients within half a bf16 ulp of the plain version's
    unrounded float32 value on the same inputs, plus 2e-5 of the largest
    gradient (chip_smoke.py's bound for the training shape)."""
    q, k, v, do = _train_inputs(34, s, h, hkv, d, torch.bfloat16)
    o, lse = at.flash_fwd(q, k, v, causal)
    grads = at.flash_bwd(q, k, v, o, lse, do, causal)
    refs = at.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float(), causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        bound = ref.abs() * 2.0 ** -8 + 2e-5 * float(ref.abs().max())
        assert bool(((got.float() - ref).abs() <= bound).all()), name


# -- the host KV tier and the KV handoff on the kernel path --------------------

def _tier_engine(cfg, params, dev, impl, **kw):
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    return PagedContinuousBatchingEngine(
        cfg, params, max_len=64, slots=2, prefill_buckets=(16,),
        page_size=8, attention_impl=impl, device=dev, **kw)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_promoted_prefix_hit_runs_paged_prefill_kernel(dev, kv_dtype):
    """A prompt's evicted pages demote to the host tier and its rerun
    promotes them: the paged prefill kernel reads the promoted pages (its
    counter moves, nothing is gathered), the pages come back bit for bit,
    and the tokens equal the plain versions' (a reference-attention
    engine on the same sequence)."""
    from mlrun_tpu_torch.models import llama

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(9), dev)
    p1, p2 = list(range(1, 30)), list(range(50, 100))
    prefill = "paged_prefill" if kv_dtype == "native" \
        else "paged_prefill_int8"
    outs = []
    for impl in ("auto", "reference"):
        eng = _tier_engine(cfg, params, dev, impl, n_pages=8,
                           kv_dtype=kv_dtype,
                           kv_tier={"host_bytes": 32 << 20})
        try:
            cold = eng.generate(p1, max_new_tokens=4)[0]
            before = eng.fetch_prefix(p1).result(timeout=120)
            eng.generate(p2, max_new_tokens=4)
            chunks = eng.stats["prefill_kernel_chunks"]
            _build.reset_launch_counts()
            again = eng.generate(p1, max_new_tokens=4)[0]
            counts = _build.launch_counts()
            after = eng.fetch_prefix(p1).result(timeout=120)
            stats = eng.stats
        finally:
            eng.stop()
        assert stats["kv_promoted_pages"] == 2
        for name in before.kv:
            assert (before.kv[name] == after.kv[name]).all(), name
        if impl == "auto":
            # one launch a layer for every prefix-hit dispatch of the
            # promoted rerun (its chunk and its last-token replay)
            assert counts[prefill] == cfg.n_layers * (
                stats["prefill_kernel_chunks"] - chunks) > 0
            assert stats["prefill_gather_admissions"] == 0
        outs.append((cold, again))
    assert outs[0] == outs[1] and outs[0][0] == outs[0][1]


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_imported_handoff_decodes_on_paged_decode_kernel(dev, kv_dtype):
    """submit_prefill -> submit_prefilled between two engines on the card:
    the decode engine launches no prefill kernel, decodes every tick of
    the imported pages on the paged decode kernel, and gives the tokens of
    a single reference-attention engine (the plain versions)."""
    from mlrun_tpu_torch.models import llama

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(10), dev)
    prompt = list(range(3, 44))
    decode_name = "paged_decode" if kv_dtype == "native" \
        else "paged_decode_int8"
    ref = _tier_engine(cfg, params, dev, "reference", kv_dtype=kv_dtype)
    prefill = _tier_engine(cfg, params, dev, "auto", kv_dtype=kv_dtype)
    decode = _tier_engine(cfg, params, dev, "auto", kv_dtype=kv_dtype)
    try:
        want = ref.generate(prompt, max_new_tokens=8)[0]
        handoff = prefill.submit_prefill(prompt).result(timeout=120)
        _build.reset_launch_counts()
        got = decode.submit_prefilled(handoff,
                                      max_new_tokens=8).result(timeout=120)
        counts = _build.launch_counts()
    finally:
        for eng in (ref, prefill, decode):
            eng.stop()
    assert got[0] == want
    assert counts["flash_fwd_cached"] == 0
    assert counts[decode_name] == cfg.n_layers * 7
    if kv_dtype == "int8":
        assert handoff.kv["k"].dtype.name == "int8"


# -- the engine fleet on the card ------------------------------------------------

def test_fleet_fetched_prefix_hit_runs_paged_prefill_kernel(dev):
    """Two replicas on one card from one param tree: a concurrent burst
    gives each prompt its lone tokens (the replicas' scheduler threads
    share the stream and its split-K counters); then a third replica
    joins, the next request on a moved hot key fetches the old owner's
    prefix pages, and its prefill runs the paged prefill kernel over the
    imported pages, with the tokens of a device hit on the old owner."""
    import numpy as np

    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.serving.fleet import ConsistentHashRing, EngineFleet

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, _gen(11), dev)
    fleet = EngineFleet(lambda role: _tier_engine(cfg, params, dev, "auto"),
                        replicas=2)
    probe = ConsistentHashRing(vnodes=fleet._ring.vnodes)
    for node in fleet._ring.nodes():
        probe.add(node)
    candidate = f"{fleet._fleet_id}-u{fleet._replica_seq}"
    probe.add(candidate)
    prompts = [np.random.default_rng(s).integers(1, 512, 30).tolist()
               for s in range(60)]
    moving = [p for p in prompts
              if probe.lookup(fleet.routing_key(p)) == candidate][0]
    burst = prompts[:6]
    try:
        lone = [fleet.generate(p, max_new_tokens=6)[0] for p in burst]
        futures = [fleet.submit(p, max_new_tokens=6) for p in burst]
        together = [f.result(timeout=300)[0] for f in futures]
        warm = fleet.generate(moving, max_new_tokens=4)[0]
        hit = fleet.generate(moving, max_new_tokens=4)[0]
        added = fleet.add_replica("unified")
        chunks = fleet.stats["per_replica"][added]["prefill_kernel_chunks"]
        _build.reset_launch_counts()
        fetched, stats = fleet.generate(moving, max_new_tokens=4)
        counts = _build.launch_counts()
        row = fleet.stats["per_replica"][added]
        fleet_stats = fleet.stats
    finally:
        fleet.stop()
    assert together == lone
    assert fetched == hit == warm
    assert stats["replica"] == added and fleet_stats["prefix_fetches"] == 1
    assert stats["timing"]["cached_prefix"] == 24
    assert counts["paged_prefill"] == cfg.n_layers * (
        row["prefill_kernel_chunks"] - chunks) > 0
    assert row["prefill_gather_admissions"] == 0
