"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on an NVIDIA GPU. Every test here is marked ``cuda`` and skips
without a CUDA device (a CUDA kernel has no CPU or interpret mode); the
CPU suite holds the plain versions against the JAX reference instead
(tests/test_torch_ops.py).

Run on a GPU machine (JAX need not be installed there, hence no conftest):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances (max abs error, kernel vs plain version on the same inputs):
float32 outputs and every lse 2e-5 — only the summation order differs;
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
    (130, 4, 4, 128, False), (256, 8, 1, 128, True), (1, 2, 1, 64, True)]


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
    assert not any(ref_counts.values())
    for a, b in zip(hist, ref_hist):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), key
