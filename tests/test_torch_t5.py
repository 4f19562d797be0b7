"""The port's T5 family (mlrun_tpu_torch/models/t5.py) against the JAX
package on the CPU, at ``tiny_t5`` size in float32 with TF32 off. Params
are the reference's ``init_params`` converted with ``params_from_numpy``
(with nonzero relative-bias tables, which the reference's init leaves at
zero); inputs come from numpy seeds. T5's biased attention is plain in
both packages: it reaches no kernel.

Tolerances (the Llama parity tests'): relative-position buckets exactly;
biases, encodings and logits 1e-4 absolute; loss, accuracy and gradients
1e-5; each train step's loss and grad norm 1e-4 relative. Looser,
``ADAM_EPS_TOL``: the params after a step (absolute). AdamW's first
update is ``g / (|g| + eps)``; for a gradient element near eps (1e-8)
its derivative is ``1 / (4 eps)``, so float32 summation noise of ~1e-9
there moves that element by a tenth of a learning-rate step. The tiny
T5's gradients hold a few such elements (|g| < 1e-7 in decoder ``wv``,
``w_up``, ``w_gate``, the embedding): one step moves the params 6.2e-4
apart (lr 1e-2) while every gradient agrees within 1.4e-6. Left to run
free for three steps, that gap compounds with the CPU's summation
order: 3.0e-3 relative on the third grad norm and 6.9e-3 on the params
on one machine, 6.9e-4 and 8.9e-4 on another. So the step test starts
every step from the reference's state (params and both moments carried
over), where the steps' gradients agree within 4.7e-6, their grad norms
within 5.5e-6 relative and their params within 6.2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlrun_tpu.models import t5 as jt5
from mlrun_tpu_torch import models as tmodels
from mlrun_tpu_torch.models import t5 as tt5
from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from mlrun_tpu_torch.training import train as ttrain

LOGIT_TOL = 1e-4
TOL = 1e-5
RUN_REL_TOL = 1e-4
ADAM_EPS_TOL = 2e-3


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix.rstrip("."), tree


def _assert_trees_close(jtree, ttree, tol):
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    for key, arr in jl.items():
        other = tl[key]
        if isinstance(other, torch.Tensor):
            other = other.detach().float().numpy()
        diff = np.abs(np.asarray(arr, np.float32) - other).max()
        assert diff <= tol, f"{key}: max abs diff {diff} > {tol}"


def _models(seed=0, **overrides):
    jcfg = jt5.tiny_t5(dtype=jnp.float32, **overrides)
    jparams = dict(jt5.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for name in ("enc_rel_bias", "dec_rel_bias"):
        jparams[name] = jnp.asarray(
            rng.standard_normal(jparams[name].shape).astype(np.float32))
    tcfg = tt5.tiny_t5(dtype=torch.float32, **overrides)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(seed, b=3, s_enc=12, s_dec=9, vocab=256):
    """Encoder ids with a padded tail on each row (mask: bool, True =
    attend), decoder ids, targets and a target mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s_enc), dtype=np.int32)
    enc_mask = np.ones((b, s_enc), bool)
    for row, pad in enumerate(rng.integers(0, s_enc // 2, b)):
        enc_mask[row, s_enc - pad:] = False
    dec = rng.integers(0, vocab, (b, s_dec), dtype=np.int32)
    targets = rng.integers(0, vocab, (b, s_dec), dtype=np.int32)
    target_mask = (rng.random((b, s_dec)) > 0.25).astype(np.float32)
    return ids, enc_mask, dec, targets, target_mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("preset", ["t5_base", "tiny_t5"])
def test_relative_position_buckets_match_reference_exactly(preset,
                                                           bidirectional):
    """Every relative position in [-1024, 1024]: both logs are float32 and
    the bucket truncates toward zero, so each position lands in the
    reference's bucket, the edges at powers of two included."""
    cfg = getattr(tt5, preset)()
    rel = np.arange(-1024, 1025, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, cfg.rel_buckets,
        cfg.rel_max_distance))
    got = tt5.relative_position_bucket(
        torch.from_numpy(rel).long(), bidirectional, cfg.rel_buckets,
        cfg.rel_max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < cfg.rel_buckets


def test_rel_bias_matches_reference():
    jcfg, jparams, tcfg, tparams = _models(seed=1)
    for q_len, k_len, bidirectional in ((7, 7, True), (9, 5, False),
                                        (40, 40, True)):
        want = jt5.rel_bias(jcfg, jparams["enc_rel_bias"], q_len, k_len,
                            bidirectional)
        got = tt5.rel_bias(tcfg, tparams["enc_rel_bias"], q_len, k_len,
                           bidirectional)
        assert got.shape == (tcfg.n_heads, q_len, k_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_and_decode_match_reference():
    """``encode`` with an encoder padding mask, then the teacher-forced
    ``decode`` (causal bias, cross-attention under the same mask, the
    tied head scaled by embed_dim ** -0.5)."""
    jcfg, jparams, tcfg, tparams = _models(seed=2)
    ids, enc_mask, dec, _, _ = _batch(3)
    assert not enc_mask.all()
    for mask in (None, enc_mask):
        j_mask = None if mask is None else jnp.asarray(mask)
        t_mask = None if mask is None else torch.from_numpy(mask)
        j_enc = jt5.encode(jcfg, jparams, jnp.asarray(ids), j_mask)
        j_logits = jt5.decode(jcfg, jparams, j_enc, jnp.asarray(dec), j_mask)
        with torch.no_grad():
            t_enc = tt5.encode(tcfg, tparams, torch.from_numpy(ids), t_mask)
            t_logits = tt5.decode(tcfg, tparams, t_enc,
                                  torch.from_numpy(dec), t_mask)
        assert np.abs(np.asarray(j_enc) - t_enc.numpy()).max() <= LOGIT_TOL
        assert t_logits.dtype == torch.float32
        assert np.abs(np.asarray(j_logits) - t_logits.numpy()).max() \
            <= LOGIT_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_seq2seq_loss_and_grads_match_reference(remat):
    """``seq2seq_loss`` with an encoder mask and masked targets: loss,
    accuracy and every leaf's gradient against ``jax.grad``; per-layer
    remat (T5's default) changes nothing."""
    jcfg, jparams, tcfg, tparams = _models(seed=4)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    batch = _batch(5)

    def jloss(p):
        ids, enc_mask, dec, targets, target_mask = map(jnp.asarray, batch)
        return jt5.seq2seq_loss(jcfg, p, ids, dec, targets,
                                enc_mask=enc_mask, target_mask=target_mask)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = ttrain.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), tparams)
    ids, enc_mask, dec, targets, target_mask = _t(*batch)
    tl, tm = tt5.seq2seq_loss(tcfg, tparams, ids, dec, targets,
                              enc_mask=enc_mask, target_mask=target_mask)
    tl.backward()
    assert abs(float(jl) - tl.item()) <= TOL
    for key in ("loss", "accuracy"):
        assert abs(float(jm[key]) - tm[key].item()) <= TOL, key
    _assert_trees_close(jg, ttrain.tree_map(lambda t: t.grad, tparams), TOL)


def _adamw_state_from_reference(jstate) -> ttrain.AdamWState:
    """The port's AdamW state holding optax.adamw's count and moments."""
    adam = jstate[0]
    return ttrain.AdamWState(
        int(adam.count),
        params_from_numpy(jax.tree.map(np.asarray, adam.mu), "cpu"),
        params_from_numpy(jax.tree.map(np.asarray, adam.nu), "cpu"))


def test_train_step_matches_reference():
    """Three steps of ``make_train_step`` on the port's AdamW against the
    reference's step with ``optax.adamw``. Each step starts both sides
    from the reference's state (params and moments converted), so the
    comparison holds every step's own arithmetic and not the drift of
    the steps before it (module docstring): every gradient at ``TOL``,
    the loss and grad norm at ``RUN_REL_TOL``, the params after the
    update at ``ADAM_EPS_TOL``."""
    jcfg, jparams, tcfg, _ = _models(seed=6)
    lr = 1e-2
    joptim = optax.adamw(lr)
    jstep = jt5.make_train_step(jcfg, joptim)
    jstate = joptim.init(jparams)
    toptim = ttrain.AdamW(lambda count: lr, b1=0.9, b2=0.999,
                          weight_decay=1e-4)
    tstep = tt5.make_train_step(tcfg, toptim)
    for i in range(3):
        ids, _, dec, targets, _ = _batch(10 + i)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        tstate = _adamw_state_from_reference(jstate)
        assert tstate.count == i
        jgrads = jax.grad(lambda p: jt5.seq2seq_loss(
            jcfg, p, jnp.asarray(ids), jnp.asarray(dec),
            jnp.asarray(targets))[0])(jparams)
        tgrads, _ = tstep.compute_grads(tparams, *_t(ids, dec, targets))
        names = [name for name, _ in _leaves(tparams)]
        _assert_trees_close(jgrads, dict(zip(names, tgrads)), TOL)
        jparams, jstate, jm = jstep(jparams, jstate, ids, dec, targets)
        tparams, tstate, tm = tstep(tparams, tstate, *_t(ids, dec, targets))
        assert set(tm) == set(jm) == {"loss", "accuracy", "grad_norm"}
        for key in ("loss", "grad_norm"):
            assert abs(float(jm[key]) - float(tm[key])) \
                <= RUN_REL_TOL * abs(float(jm[key])), (i, key)
        _assert_trees_close(jax.tree.map(np.asarray, jparams),
                            params_to_numpy(tparams), ADAM_EPS_TOL)


def test_param_count_flops_and_exports():
    for name in ("t5_base", "t5_large", "tiny_t5"):
        for overrides in ({}, {"tie_embeddings": False}):
            jcfg = getattr(jt5, name)(**overrides)
            tcfg = getattr(tt5, name)(**overrides)
            assert tcfg.param_count() == jcfg.param_count()
            for enc_len, dec_len in ((512, 128), (16, 0)):
                assert tcfg.flops_per_token(enc_len, dec_len) \
                    == jcfg.flops_per_token(enc_len, dec_len)
    for tied in (True, False):
        tcfg = tt5.tiny_t5(dtype=torch.float32, tie_embeddings=tied)
        params = tt5.init_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
        assert sum(t.numel() for t in ttrain.tree_leaves(params)) \
            == tcfg.param_count()
        shapes = jax.tree.map(lambda a: tuple(a.shape), jt5.param_shapes(
            jt5.tiny_t5(tie_embeddings=tied)))
        assert ttrain.tree_map(lambda t: tuple(t.shape), params) == shapes
    # t5's verbs stay namespaced; its configs are exported
    assert tmodels.t5 is tt5 and tmodels.T5Config is tt5.T5Config
    assert tmodels.t5_base is tt5.t5_base


def test_converter_carries_the_t5_tree():
    """``params_from_numpy`` / ``params_to_numpy`` carry the reference's
    t5 tree (``encoder`` / ``decoder``, the float32 bias tables) across unchanged: bf16 leaves stay bf16 (exactly,
    through float32), float32 leaves float32, an int32 leaf int32."""
    tree = jax.tree.map(np.asarray, jt5.init_params(jt5.tiny_t5(), jax.random.PRNGKey(0)))
    tree["step"] = np.arange(3, dtype=np.int32)
    ported = params_from_numpy(tree, "cpu")
    assert ported.keys() == tree.keys()
    for (name, arr), (_, tensor) in zip(_leaves(tree), _leaves(ported)):
        kind = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int32": torch.int32}[arr.dtype.name]
        assert tensor.dtype == kind and tuple(tensor.shape) == arr.shape, \
            name
    back = params_to_numpy(ported)
    for (name, arr), (_, out) in zip(_leaves(tree), _leaves(back)):
        np.testing.assert_array_equal(out, arr.astype(out.dtype), name)
