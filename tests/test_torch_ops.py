"""mlrun_tpu_torch ops against the JAX reference (mlrun_tpu.ops) on the CPU.

The same inputs, drawn from numpy's seeded generator, go through the JAX
function and its port counterpart. The Pallas kernels run as the JAX
package's own tests run them on the CPU (``interpret=True``); the port's
wrappers, given CPU tensors, run their plain PyTorch versions — the
functions the CUDA kernels are held against on the GPU
(tests/test_torch_kernels.py, chip_smoke.py).

Tolerance: 1e-5 absolute in float32 for every attention output and lse
(inputs are O(1); the two sides differ only in summation order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.ops import norms as jnorms
from mlrun_tpu.ops import paged_attention as jpaged
from mlrun_tpu.ops import rotary as jrotary
from mlrun_tpu_torch.ops import attention as tattn
from mlrun_tpu_torch.ops import norms as tnorms
from mlrun_tpu_torch.ops import paged_attention as tpaged
from mlrun_tpu_torch.ops import rotary as trotary

# mlrun_tpu.ops re-exports an ``attention`` function under the submodule's
# name, so the module is looked up directly
jattn = importlib.import_module("mlrun_tpu.ops.attention")

TOL = 1e-5


def _pair(arr):
    """(jax array, torch tensor) of the same float32/int32 numpy data."""
    arr = np.ascontiguousarray(arr)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _close(j, t, tol=TOL):
    diff = np.abs(np.asarray(j, np.float32) - t.detach().float().numpy())
    assert diff.max() <= tol, f"max abs diff {diff.max()} > {tol}"


# -- rope / rms_norm ----------------------------------------------------------

@pytest.mark.parametrize("head_dim", [32, 128])
def test_rope_matches_reference(head_dim):
    """Positions < 32: the two frameworks' f32 ``pow`` may round a
    frequency one ulp apart, and the angle error grows with the position
    (pos * ulp), so the 1e-5 bound holds in that range."""
    rng = np.random.default_rng(0)
    pos_j, pos_t = _pair(np.arange(32, dtype=np.int32))
    cos_j, sin_j = jrotary.rope_table(pos_j, head_dim)
    cos_t, sin_t = trotary.rope_table(pos_t, head_dim)
    _close(cos_j, cos_t)
    _close(sin_j, sin_t)
    x_j, x_t = _pair(rng.standard_normal((2, 32, 4, head_dim), np.float32))
    _close(jrotary.apply_rope(x_j, cos_j, sin_j),
           trotary.apply_rope(x_t, cos_t, sin_t))
    # per-row tables ([batch, seq, half]) as the decode step uses them
    rows_j, rows_t = _pair(np.array([[3], [29]], np.int32))
    c_j, s_j = jrotary.rope_table(rows_j, head_dim)
    c_t, s_t = trotary.rope_table(rows_t, head_dim)
    y_j, y_t = _pair(rng.standard_normal((2, 1, 4, head_dim), np.float32))
    _close(jrotary.apply_rope(y_j, c_j, s_j),
           trotary.apply_rope(y_t, c_t, s_t))


@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 64)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(1)
    x_j, x_t = _pair(rng.standard_normal(shape, np.float32) * 3)
    s_j, s_t = _pair(rng.standard_normal(shape[-1:], np.float32))
    _close(jnorms.rms_norm(x_j, s_j), tnorms.rms_norm(x_t, s_t))


# -- cached flash (plain version) vs the Pallas kernel in interpret mode ------

FLASH_CASES = [
    # (S, M, q_offset, k_lo, repeated kv)
    (8, 32, 0, 0, True),
    (6, 32, 10, 0, True),
    (16, 48, 20, 0, False),
    (8, 40, 16, 16, True),
    (12, 64, 24, 8, False),
]


@pytest.mark.parametrize("s,m,q_offset,k_lo,repeated", FLASH_CASES)
def test_flash_cached_plain_matches_pallas(s, m, q_offset, k_lo, repeated):
    rng = np.random.default_rng(2)
    b, h, hkv, d = 1, 4, 2, 16
    q_j, q_t = _pair(rng.standard_normal((b, s, h, d), np.float32))
    k_np = rng.standard_normal((b, m, hkv, d), np.float32)
    v_np = rng.standard_normal((b, m, hkv, d), np.float32)
    # the reference takes kv repeated to the q heads; the port takes both
    k_rep = np.repeat(k_np, h // hkv, axis=2)
    v_rep = np.repeat(v_np, h // hkv, axis=2)
    k_j, v_j = jnp.asarray(k_rep), jnp.asarray(v_rep)
    k_t = torch.from_numpy(k_rep if repeated else k_np)
    v_t = torch.from_numpy(v_rep if repeated else v_np)
    if k_lo:
        o_j, lse_j = jattn._flash_fwd_v2_cached_bounded(
            q_j, k_j, v_j, q_offset, k_lo, interpret=True)
        o_t, lse_t = tattn._flash_fwd_v2_cached_bounded(q_t, k_t, v_t,
                                                        q_offset, k_lo)
    else:
        o_j, lse_j = jattn._flash_fwd_v2_cached(q_j, k_j, v_j, q_offset,
                                                interpret=True)
        o_t, lse_t = tattn._flash_fwd_v2_cached(q_t, k_t, v_t, q_offset)
    assert o_t.shape == (b, s, h, d) and lse_t.shape == (b, h, s)
    _close(o_j, o_t)
    _close(lse_j, lse_t)


def test_flash_attention_cached_offset_zero_is_causal_attention():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 9, 2, 16), np.float32))
    out = tattn.flash_attention_cached(q, k, v, 0)
    ref = tattn.attention_reference(q, k, v, causal=True)
    assert float((out - ref).abs().max()) <= TOL


# -- paged decode / paged prefill (plain versions) vs Pallas interpret --------

def _pool(rng, n_pages, page_size, hkv, d):
    k = rng.standard_normal((n_pages + 1, page_size, hkv, d), np.float32)
    v = rng.standard_normal((n_pages + 1, page_size, hkv, d), np.float32)
    return _pair(k), _pair(v)


@pytest.mark.parametrize("n_rep", [1, 2])
def test_paged_decode_plain_matches_pallas(n_rep):
    """-1 entries in the table, a position mid-page, one on the first
    entry of a page (pos % page_size == 0) and one on a page's last."""
    rng = np.random.default_rng(4)
    slots, pps, ps, hkv, d = 4, 4, 8, 2, 16
    h = hkv * n_rep
    (kj, kt), (vj, vt) = _pool(rng, 12, ps, hkv, d)
    q_j, q_t = _pair(rng.standard_normal((slots, h, d), np.float32))
    table = np.full((slots, pps), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, :4] = [0, 1, 2, 8]
    table[2, :3] = [9, 10, 11]
    table[3, :1] = [5]
    pos = np.array([11, 31, 16, 7], np.int32)
    tab_j, tab_t = _pair(table)
    pos_j, pos_t = _pair(pos)
    out_j = jpaged._paged_decode_call(q_j, kj, vj, tab_j, pos_j, ps,
                                      interpret=True)
    out_t = tpaged._paged_decode_call(q_t, kt, vt, tab_t, pos_t, ps)
    assert out_t.shape == (slots, h, d) and out_t.dtype == torch.float32
    _close(out_j, out_t)
    _close(jpaged.paged_decode_reference(q_j, kj, vj, tab_j, pos_j, ps),
           tpaged.paged_attention(q_t, kt, vt, tab_t, pos_t, page_size=ps))


@pytest.mark.parametrize("s,base", [(5, 16), (12, 24), (1, 8)])
def test_paged_prefill_plain_matches_pallas(s, base):
    rng = np.random.default_rng(5)
    pps, ps, hkv, d, h = 4, 8, 2, 16, 4
    (kj, kt), (vj, vt) = _pool(rng, 10, ps, hkv, d)
    q_j, q_t = _pair(rng.standard_normal((s, h, d), np.float32))
    ids = np.full((pps,), -1, np.int32)
    ids[:-(-base // ps)] = [6, 2, 9][:-(-base // ps)]
    ids_j, ids_t = _pair(ids)
    o_j, lse_j = jpaged._paged_prefill_call(q_j, kj, vj, ids_j, base, ps,
                                            interpret=True)
    o_t, lse_t = tpaged._paged_prefill_call(q_t, kt, vt, ids_t, base, ps)
    assert o_t.shape == (s, h, d) and lse_t.shape == (s, h)
    _close(o_j, o_t)
    _close(lse_j, lse_t)
    # the batch-1 form in the flash lse layout
    o1_j, lse1_j = jpaged.paged_prefix_part(q_j[None], kj, vj, ids_j, base,
                                            page_size=ps, interpret=True)
    o1_t, lse1_t = tpaged.paged_prefix_part(q_t[None], kt, vt, ids_t, base,
                                            page_size=ps)
    _close(o1_j, o1_t)
    _close(lse1_j, lse1_t)


def test_merge_softmax_states_matches_reference():
    rng = np.random.default_rng(6)
    shape_o, shape_l = (1, 5, 4, 16), (1, 4, 5)
    parts = [_pair(rng.standard_normal(shape, np.float32) * scale)
             for shape, scale in ((shape_o, 1), (shape_l, 3),
                                  (shape_o, 1), (shape_l, 3))]
    (oa_j, oa_t), (la_j, la_t), (ob_j, ob_t), (lb_j, lb_t) = parts
    _close(jpaged.merge_softmax_states(oa_j, la_j, ob_j, lb_j),
           tpaged.merge_softmax_states(oa_t, la_t, ob_t, lb_t))


def test_merged_prefix_prefill_equals_attention_over_the_union():
    """Paged prefix part + bounded flash over the suffix, LSE-merged,
    equals one cached attention over prefix + suffix (the hit-path
    contract), on the port's plain versions."""
    rng = np.random.default_rng(7)
    ps, base, s, h, hkv, d = 8, 16, 6, 4, 2, 16
    m = 32
    k_all = rng.standard_normal((1, m, hkv, d), np.float32)
    v_all = rng.standard_normal((1, m, hkv, d), np.float32)
    q = torch.from_numpy(rng.standard_normal((1, s, h, d), np.float32))
    k_pages = np.zeros((5, ps, hkv, d), np.float32)
    v_pages = np.zeros((5, ps, hkv, d), np.float32)
    k_pages[[3, 1]] = k_all[0, :base].reshape(2, ps, hkv, d)
    v_pages[[3, 1]] = v_all[0, :base].reshape(2, ps, hkv, d)
    local_k, local_v = k_all.copy(), v_all.copy()
    local_k[:, :base] = 0
    local_v[:, :base] = 0
    ids = torch.tensor([3, 1, -1, -1], dtype=torch.int32)
    merged = tpaged.paged_prefill_attention(
        q, torch.from_numpy(local_k), torch.from_numpy(local_v), base,
        torch.from_numpy(k_pages), torch.from_numpy(v_pages), ids, base,
        page_size=ps)
    full = tattn.flash_attention_cached(q, torch.from_numpy(k_all),
                                        torch.from_numpy(v_all), base)
    assert float((merged - full).abs().max()) <= TOL


def test_resolve_impls_follow_the_device():
    assert tattn.resolve_prefill_impl("auto", "cpu") == "dense"
    assert tattn.resolve_prefill_impl("auto", "cuda") == "flash"
    assert tpaged.resolve_paged_impl("auto", "cpu") == "reference"
    assert tpaged.resolve_paged_impl("auto", "cuda") == "kernel"
    assert tpaged.resolve_paged_impl("reference", "cuda") == "reference"
    for impl in ("kernel", "flash"):
        with pytest.raises(tpaged.KernelUnavailableError):
            tpaged.resolve_paged_impl(impl, "cpu")
        with pytest.raises(tpaged.KernelUnavailableError):
            tattn.resolve_prefill_impl(impl, "cpu")
    with pytest.raises(ValueError):
        tpaged.resolve_paged_impl("bogus", "cpu")


# -- training flash: forward and backward vs flash_attention_mlt --------------

TRAIN_FLASH_CASES = [
    # (S, H, Hkv, causal) — S 70 and 40 are not multiples of the port's
    # 64-row tiles
    (70, 4, 2, True),
    (70, 4, 2, False),
    (40, 4, 1, True),
    (64, 2, 2, False),
]


@pytest.mark.parametrize("s,h,hkv,causal", TRAIN_FLASH_CASES)
def test_flash_fwd_plain_matches_pallas(s, h, hkv, causal):
    """The training forward (``_flash_fwd_v2``, the Pallas
    ``_flash_fwd_kernel_v2`` in interpret mode) against the port's plain
    version, o and lse; the port takes kv at the kv head count."""
    rng = np.random.default_rng(8)
    b, d = 2, 16
    q_j, q_t = _pair(rng.standard_normal((b, s, h, d), np.float32))
    k_np = rng.standard_normal((b, s, hkv, d), np.float32)
    v_np = rng.standard_normal((b, s, hkv, d), np.float32)
    k_j = jnp.asarray(np.repeat(k_np, h // hkv, axis=2))
    v_j = jnp.asarray(np.repeat(v_np, h // hkv, axis=2))
    o_j, lse_j = jattn._flash_fwd_v2(q_j, k_j, v_j, causal=causal,
                                     interpret=True)
    o_t, lse_t = tattn.flash_fwd(q_t, torch.from_numpy(k_np),
                                 torch.from_numpy(v_np), causal)
    assert o_t.shape == (b, s, h, d) and lse_t.shape == (b, h, s)
    _close(o_j, o_t)
    _close(lse_j, lse_t)


@pytest.mark.parametrize("s,h,hkv,causal", TRAIN_FLASH_CASES)
def test_flash_attention_grads_match_jax(s, h, hkv, causal):
    """Autograd through the port's ``flash_attention_mlt`` (its plain
    forward and backward on the CPU) against ``jax.grad`` through the
    reference's ``_repeat_kv`` + ``flash_attention_mlt`` (Pallas forward in
    interpret mode, ``_blockwise_bwd``): dq, and dk/dv at the kv head
    count. Tolerance 1e-5 absolute in float32 (O(1) inputs and
    cotangent; only the summation order differs)."""
    import jax

    rng = np.random.default_rng(9)
    b, d = 1, 16
    q_np = rng.standard_normal((b, s, h, d), np.float32)
    k_np = rng.standard_normal((b, s, hkv, d), np.float32)
    v_np = rng.standard_normal((b, s, hkv, d), np.float32)
    w_np = rng.standard_normal((b, s, h, d), np.float32)
    n_rep = h // hkv

    def loss_j(q, k, v):
        o = jattn.flash_attention_mlt(q, jattn._repeat_kv(k, n_rep),
                                      jattn._repeat_kv(v, n_rep), causal)
        return jnp.sum(o * jnp.asarray(w_np))

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np))
    q_t, k_t, v_t = (torch.from_numpy(a.copy()).requires_grad_(True)
                     for a in (q_np, k_np, v_np))
    o_t = tattn.flash_attention_mlt(q_t, k_t, v_t, causal)
    (o_t * torch.from_numpy(w_np)).sum().backward()
    for gj, gt, shape in zip(grads_j, (q_t.grad, k_t.grad, v_t.grad),
                             (q_np.shape, k_np.shape, v_np.shape)):
        assert tuple(gt.shape) == shape
        _close(gj, gt)


def test_flash_bwd_plain_masks_padded_keys():
    """``kv_len`` masks a padded key tail in both directions: the padded
    rows get zero dk/dv and leave o, lse and dq as without them."""
    rng = np.random.default_rng(10)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                  for shape in ((1, 6, 2, 8), (1, 9, 1, 8), (1, 9, 1, 8),
                                (1, 6, 2, 8)))
    o, lse = tattn.flash_fwd_plain(q, k, v, causal=False, kv_len=6)
    o6, lse6 = tattn.flash_fwd_plain(q, k[:, :6], v[:, :6], causal=False)
    _close(o6.numpy(), o)
    _close(lse6.numpy(), lse)
    dq, dk, dv = tattn.flash_bwd_plain(q, k, v, o, lse, g, causal=False,
                                       kv_len=6)
    dq6, dk6, dv6 = tattn.flash_bwd_plain(q, k[:, :6], v[:, :6], o6, lse6,
                                          g, causal=False)
    _close(dq6.numpy(), dq)
    _close(dk6.numpy(), dk[:, :6])
    _close(dv6.numpy(), dv[:, :6])
    assert not dk[:, 6:].any() and not dv[:, 6:].any()


def test_attention_dispatch_impls():
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 10, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 10, 2, 8), np.float32))
    ref = tattn.attention_reference(q, k, k, causal=True)
    for impl in ("auto", "flash", "mlt_flash", "reference"):
        out = tattn.attention(q, k, k, causal=True, impl=impl)
        assert float((out - ref).abs().max()) <= TOL
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, k, impl="bogus")
