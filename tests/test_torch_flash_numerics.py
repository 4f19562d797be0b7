"""The numerics of the bf16 tensor-core flash kernels (csrc/flash_fwd_tc.cu,
csrc/flash_bwd_tc.cu), emulated in plain PyTorch on the CPU and held
against the port's plain versions under the bounds the GPU checks state.

The emulation keeps the kernels' rounding points and nothing else of
their schedule: bf16 operands, products exact in float32; the scale
multiplies the float32 dot product (never folded into bf16 q); key tiles
of 64 from position 0 in ascending order, each tile's product summed in a
fresh float32 accumulator and then added to the running one; in the
forward, p rounded to bf16 only as the operand of P V while l sums the
float32 p; in the backward, P and dS split into hi = bf16(x) and
lo = bf16(x - hi) for the products they feed. The bounds:

- forward o within 1.6e-2 and lse within 2e-5 of ``_flash_fwd_plain``
  (tests/test_torch_kernels.py's bf16 ``TOL`` and ``LSE_TOL``);
- backward gradients, rounded to bf16, within half a bf16 ulp (2**-8 of
  the value) of ``flash_bwd_plain``'s unrounded float32 result on the same
  bf16 inputs, plus 2e-5 of the largest gradient (chip_smoke.py's
  ``BF16_HALF_ULP`` and ``BF16_GRAD_FLOOR``).
"""

import numpy as np
import pytest
import torch

from mlrun_tpu_torch.ops import attention as at
from tests.torch_threads import one_torch_thread  # noqa: F401

TILE = 64
O_TOL = 1.6e-2
LSE_TOL = 2e-5
BF16_HALF_ULP = 2.0 ** -8
BF16_GRAD_FLOOR = 2e-5


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


def _inputs(seed, b, s, m, h, hk, d):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (b, s, h, d)), _bf16(rng, (b, m, hk, d), 0.5),
            _bf16(rng, (b, m, hk, d)), _bf16(rng, (b, s, h, d)))


def _heads(x, h):
    """[B, M, Hk, D] -> [B, H, M, D] float32, query head i reading kv head
    i // (H // Hk)."""
    return x.float().repeat_interleave(h // x.shape[2], dim=2).transpose(1, 2)


def _dot_rows(a, b):
    """[.., S, D] x [.., T, D] -> [.., S, T]: float32 products summed over
    D one term at a time, so a row's value never depends on the others."""
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for i in range(a.shape[-1]):
        out = out + a[..., :, None, i] * b[..., None, :, i]
    return out


def _row_sum(p):
    """Sum over a 64-key tile in the kernel's order: a thread adds its two
    neighbouring keys of each 8-key block, the blocks in order, then a quad
    butterfly over the four threads of the row."""
    pairs = p[..., 0::2] + p[..., 1::2]                  # [.., 32]
    pairs = pairs.reshape(p.shape[:-1] + (8, 4))         # block n, thread t
    local = pairs[..., 0, :]
    for n in range(1, 8):
        local = local + pairs[..., n, :]
    return (local[..., 0] + local[..., 1]) + (local[..., 2] + local[..., 3])


def emulate_fwd(q, k, v, q_offset=0, k_lo=0, causal=True):
    """(o bf16, lse [B, H, S] f32) at the forward kernel's rounding points;
    q rows at q_offset + i over keys k_lo <= k_pos < M (<= the row's
    position when causal)."""
    b, s, h, d = q.shape
    m = k.shape[1]
    scale = d ** -0.5
    qf = q.float().transpose(1, 2)                       # [B, H, S, D]
    kf, vf = _heads(k, h), _heads(v, h)
    q_pos = q_offset + torch.arange(s)
    m_run = torch.full((b, h, s), at.NEG_INF)
    l_run = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    last = min(q_offset + s - 1, m - 1) if causal else m - 1
    for k0 in range(k_lo // TILE * TILE, last + 1, TILE):
        k_pos = torch.arange(k0, k0 + TILE)
        kt = torch.zeros((b, h, TILE, d))
        vt = torch.zeros((b, h, TILE, d))
        n = min(TILE, m - k0)
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        x = _dot_rows(qf, kt) * scale
        live = (k_pos[None] >= k_lo) & (k_pos[None] < m)
        if causal:
            live = live & (k_pos[None] <= q_pos[:, None])
        x = torch.where(live, x, torch.full_like(x, at.NEG_INF))
        m_new = torch.maximum(m_run, x.amax(dim=-1))
        alpha = torch.where(m_new == m_run, torch.ones_like(m_new),
                            torch.exp(m_run - m_new))
        p = torch.exp(x - m_new[..., None])
        l_run = l_run * alpha + _row_sum(p)
        pb = p.bfloat16().float()                         # P V's operand
        pv = torch.zeros_like(acc)
        for j in range(TILE):
            pv = pv + pb[..., j:j + 1] * vt[..., j:j + 1, :]
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    den = l_run.clamp_min(1e-30)
    o = (acc * (1.0 / den)[..., None]).transpose(1, 2)
    return o.to(q.dtype), m_run + torch.log(den)


def _split(x, split: bool):
    hi = x.bfloat16().float()
    if not split:
        return [hi]
    return [hi, (x - hi).bfloat16().float()]


def emulate_bwd(q, k, v, o, lse, g, causal=True, split=True):
    """(dq, dk, dv) in bf16 at the backward kernels' rounding points;
    ``split=False`` rounds P and dS once to bf16 instead of the hi/lo
    pair."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    n_rep = h // hk
    scale = d ** -0.5
    qf, gf = q.float().transpose(1, 2), g.float().transpose(1, 2)
    kf, vf = _heads(k, h), _heads(v, h)
    delta = (o.float() * g.float()).sum(-1).transpose(1, 2)    # [B, H, S]
    pos = torch.arange(s)
    dq = torch.zeros((b, h, s, d))
    dk = torch.zeros((b, h, s, d))
    dv = torch.zeros((b, h, s, d))
    tiles = range(0, s, TILE)
    for k0 in tiles:                      # dq kernel: key tiles in order
        ks_, vs_ = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, ks_) * scale
        live = pos[:, None] < s
        if causal:
            live = pos[k0:k0 + TILE][None] <= pos[:, None]
        p = torch.where(live, torch.exp(sc - lse[..., None]),
                        torch.zeros_like(sc))
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vs_)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + sum(part @ ks_ for part in _split(ds, split))
    for k0 in tiles:                      # dkdv kernel: a key tile's sums
        ks_, vs_ = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        acc_k = torch.zeros_like(ks_)
        acc_v = torch.zeros_like(vs_)
        for q0 in tiles:
            if causal and q0 + TILE <= k0:
                continue
            qt, gt = qf[:, :, q0:q0 + TILE], gf[:, :, q0:q0 + TILE]
            st = torch.einsum("bhkd,bhqd->bhkq", ks_, qt) * scale
            live = torch.ones(st.shape[-2:], dtype=torch.bool)
            if causal:
                live = pos[k0:k0 + TILE][:, None] <= pos[q0:q0 + TILE][None]
            pt = torch.where(live, torch.exp(st - lse[:, :, None,
                                                      q0:q0 + TILE]),
                             torch.zeros_like(st))
            dpt = torch.einsum("bhkd,bhqd->bhkq", vs_, gt)
            dst = pt * (dpt - delta[:, :, None, q0:q0 + TILE]) * scale
            acc_v = acc_v + sum(part @ gt for part in _split(pt, split))
            acc_k = acc_k + sum(part @ qt for part in _split(dst, split))
        dk[:, :, k0:k0 + TILE], dv[:, :, k0:k0 + TILE] = acc_k, acc_v

    def to_kv(x):   # sum each group of query heads, in head order
        x = x.view(b, hk, n_rep, s, d)
        total = x[:, :, 0]
        for r in range(1, n_rep):
            total = total + x[:, :, r]
        return total.transpose(1, 2).bfloat16()

    return dq.transpose(1, 2).bfloat16(), to_kv(dk), to_kv(dv)


def _grad_excess(got, ref):
    """Largest |got - ref| over its bound (<= 1 passes)."""
    bound = ref.abs() * BF16_HALF_ULP \
        + BF16_GRAD_FLOOR * float(ref.abs().max())
    return float(((got.float() - ref).abs() / bound).max())


FWD_CASES = [
    # (D, causal, S, M, q_offset, k_lo): self-attention from 0 (training,
    # v1) and the serving form over a cache, k_lo off the 64-key grid
    (32, True, 96, 96, 0, 0), (64, False, 150, 150, 0, 0),
    (128, True, 200, 200, 0, 0), (32, False, 130, 175, 0, 0),
    (64, True, 130, 200, 70, 37), (128, True, 100, 300, 200, 128)]


@pytest.mark.parametrize("d,causal,s,m,q_offset,k_lo", FWD_CASES)
def test_emulated_fwd_within_plain_bounds(d, causal, s, m, q_offset, k_lo):
    q, k, v, _ = _inputs(d + s, 2, s, m, 4, 2, d)
    o, lse = emulate_fwd(q, k, v, q_offset, k_lo, causal)
    o_ref, lse_ref = at._flash_fwd_plain(q, k, v, q_offset, k_lo, causal, m)
    assert float((o.float() - o_ref.float()).abs().max()) <= O_TOL
    assert float((lse - lse_ref).abs().max()) <= LSE_TOL


BWD_CASES = [(32, True, 96), (32, False, 130), (64, True, 150),
             (64, False, 200), (128, True, 200), (128, False, 100)]


def _bwd_case(d, causal, s, seed):
    q, k, v, g = _inputs(seed, 2, s, s, 4, 2, d)
    o, lse = at.flash_fwd_plain(q, k, v, causal)
    refs = at.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              lse, g.float(), causal)
    return (q, k, v, o, lse, g), refs


@pytest.mark.parametrize("d,causal,s", BWD_CASES)
def test_emulated_bwd_split_within_half_ulp(d, causal, s):
    args, refs = _bwd_case(d, causal, s, 100 + d + s)
    grads = emulate_bwd(*args, causal=causal, split=True)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert _grad_excess(got, ref) <= 1.0, name


def test_unsplit_bf16_ds_misses_the_bwd_bound():
    """Why the split exists: P and dS rounded once to bf16 put dq, dk and
    dv well past the bound the split meets on the same inputs."""
    args, refs = _bwd_case(64, True, 200, 7)
    split = emulate_bwd(*args, causal=True, split=True)
    unsplit = emulate_bwd(*args, causal=True, split=False)
    for name, got, ref in zip(("dq", "dk", "dv"), split, refs):
        assert _grad_excess(got, ref) <= 1.0, name
    excess = [_grad_excess(got, ref) for got, ref in zip(unsplit, refs)]
    assert min(excess[0], excess[1]) > 2.0, excess   # dq, dk: dS rounded


@pytest.mark.parametrize("d", [32, 128])
def test_emulated_fwd_chunked_prefill_is_bit_identical(d):
    """A 200-row prompt at once and in two chunks (q_offset 0 and 77) over
    the same cache give the same bits: rows never depend on where they sit
    in a launch."""
    q, k, v, _ = _inputs(11, 2, 200, 200, 4, 2, d)
    whole, whole_lse = emulate_fwd(q, k, v, 0)
    a, a_lse = emulate_fwd(q[:, :77], k, v, 0)
    b, b_lse = emulate_fwd(q[:, 77:], k, v, 77)
    assert torch.equal(whole, torch.cat([a, b], dim=1))
    assert torch.equal(whole_lse, torch.cat([a_lse, b_lse], dim=2))
