"""The numerics of the bf16 tensor-core body of csrc/paged_prefill.cu (the
paged prefill and verify over pool pages), emulated in plain PyTorch on
the CPU and held against the port's plain version under the float32
bound the GPU checks state (o and lse within 2e-5: tests/test_torch_kernels.py
``TOL[torch.float32]`` and ``LSE_TOL``, chip_smoke.py ``TOL["f32"]``).

The emulation keeps the kernel's rounding points and nothing else of its
schedule: bf16 q and pages (int8 pages as their exact integer values),
products exact in float32; the softmax scale (and an int8 page's k_scale)
multiplies the float32 dot product; key tiles of 64 from position 0, an
online softmax over each 128-key chunk, the chunks merged in order by
``lse_fold``; P (times an int8 page's v_scale) split into hi = bf16(P)
and lo = bf16(P - hi) as the operands of P V, while l sums the float32
p. One rounding of P to bf16 instead of the split misses the bound, which
is why the kernel splits it.
"""

import math

import numpy as np
import pytest
import torch

from mlrun_tpu_torch.ops import paged_attention as pa
from mlrun_tpu_torch.serving.llm import _quantize_kv

TILE, CHUNK = 64, 128
NEG_INF = -2.0 ** 30
TOL = 2e-5
LOG2E = 1.4426950408889634


def _exp2(x):
    return torch.exp2(x * LOG2E)


def _split(x, split: bool):
    """P as the kernel feeds it to P V: hi + lo bf16 terms, or one."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _fold(state, chunk):
    """lse_fold: (M, L, O) absorbs a chunk's (m, l, acc)."""
    (big_m, big_l, big_o), (m, l, acc) = state, chunk
    mn = torch.maximum(big_m, m)
    a = torch.where(mn == big_m, torch.ones_like(mn), _exp2(big_m - mn))
    b = torch.where(mn == m, torch.ones_like(mn), _exp2(m - mn))
    return mn, big_l * a + l * b, big_o * a[..., None] + acc * b[..., None]


def emulate_prefix(q, kd, vd, base, ks=None, vs=None, split=True):
    """(o [S, H, D], lse [S, H]) of q [S, H, D] (bf16) over dense prefix
    views kd/vd [M, Hkv, D] (bf16, or int8 with scales ks/vs [M, Hkv])."""
    s, h, d = q.shape
    n_rep = h // kd.shape[1]
    rep = lambda x: x.float().repeat_interleave(n_rep, dim=1)  # noqa: E731
    qf, kf, vf = q.float(), rep(kd), rep(vd)
    kscale = rep(ks) if ks is not None else None
    vscale = rep(vs) if vs is not None else None
    state = None
    for c0 in range(0, base, CHUNK):
        m = torch.full((s, h), NEG_INF)
        l = torch.zeros((s, h))
        acc = torch.zeros((s, h, d))
        for t0 in range(c0, min(c0 + CHUNK, base), TILE):
            keys = torch.arange(t0, t0 + TILE)
            x = torch.einsum("shd,khd->shk", qf, kf[t0:t0 + TILE])
            if kscale is not None:
                x = x * kscale[t0:t0 + TILE].T[None]
            x = torch.where(keys < base, x * d ** -0.5,
                            torch.full_like(x, NEG_INF))
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.where(mn == m, torch.ones_like(mn), _exp2(m - mn))
            p = _exp2(x - mn[..., None])
            l = l * alpha + p.sum(-1)
            w = p * vscale[t0:t0 + TILE].T[None] if vscale is not None else p
            acc = acc * alpha[..., None] + torch.einsum(
                "shk,khd->shd", _split(w, split), vf[t0:t0 + TILE])
            m = mn
        state = (m, l, acc) if state is None else _fold(state, (m, l, acc))
    if state is None:
        state = (torch.full((s, h), NEG_INF), torch.zeros((s, h)),
                 torch.zeros((s, h, d)))
    big_m, big_l, big_o = state
    den = big_l.clamp_min(1e-30)
    return big_o / den[..., None], big_m + torch.log(den)


def _case(seed, int8, base, s=8, h=8, hkv=2, d=128, page_size=16):
    rng = np.random.default_rng(seed)
    pps = 24
    n_pages = pps + 1
    raw_k = torch.from_numpy(rng.standard_normal(
        (n_pages + 1, page_size, hkv, d)).astype(np.float32))
    raw_v = torch.from_numpy(rng.standard_normal(
        raw_k.shape).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((s, h, d)).astype(
        np.float32)).bfloat16()
    if int8:
        k, ks = _quantize_kv(raw_k)
        v, vs = _quantize_kv(raw_v)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = (raw_k * 0.5).bfloat16(), raw_v.bfloat16()
        scales = {}
    ids = torch.from_numpy(rng.permutation(n_pages)[:pps].astype(np.int32))
    ids[-(-base // page_size):] = -1
    return q, k, v, ids, scales


def _dense(pages, ids, page_size, scale=None):
    safe = ids.clamp_min(0).long()
    g = pages[safe].reshape((-1,) + pages.shape[2:])
    return g, (None if scale is None
               else scale[safe].reshape((-1,) + scale.shape[2:]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("base", [0, 100, 300])
def test_tensor_core_prefix_numerics_within_f32_bound(int8, base):
    q, k, v, ids, scales = _case(40 + base, int8, base)
    kd, ks = _dense(k, ids, 16, scales.get("k_scale"))
    vd, vs = _dense(v, ids, 16, scales.get("v_scale"))
    o, lse = emulate_prefix(q, kd, vd, base, ks, vs)
    o_ref, lse_ref = pa.paged_prefill_reference(q, k, v, ids, base, 16,
                                                **scales)
    assert float((o - o_ref).abs().max()) <= TOL
    assert float((lse - lse_ref).abs().max()) <= TOL
    if base == 0:
        assert not o.any() and bool(
            (lse == NEG_INF + math.log(1e-30)).all())


@pytest.mark.parametrize("int8", [False, True])
def test_one_bf16_rounding_of_p_misses_the_bound(int8):
    """Without the hi/lo split the value sum is off by ~2**-9 of |v|: far
    outside 2e-5."""
    q, k, v, ids, scales = _case(47, int8, 300)
    kd, ks = _dense(k, ids, 16, scales.get("k_scale"))
    vd, vs = _dense(v, ids, 16, scales.get("v_scale"))
    o, _ = emulate_prefix(q, kd, vd, 300, ks, vs, split=False)
    o_ref, _ = pa.paged_prefill_reference(q, k, v, ids, 300, 16, **scales)
    assert float((o - o_ref).abs().max()) > 5 * TOL
