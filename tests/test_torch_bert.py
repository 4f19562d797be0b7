"""The port's BERT family (mlrun_tpu_torch/models/bert.py) against the JAX
package on the CPU, at ``tiny_bert`` size in float32 with TF32 off. Params
are the reference's ``init_params`` converted with ``params_from_numpy``;
inputs come from numpy seeds. The reference runs its plain attention (as
its own tests do on the CPU); the port runs both its plain attention and
its flash route's plain version (``auto``: the kernels' path on CUDA).

Tolerances (the Llama parity tests'): hidden states and logits 1e-4
absolute; losses, metrics and gradients 1e-5; a 3-step run 1e-4 relative
(loss, and the params after the run 1e-4 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlrun_tpu.models import bert as jbert
from mlrun_tpu_torch import models as tmodels
from mlrun_tpu_torch.models import bert as tbert
from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from mlrun_tpu_torch.training import train as ttrain

LOGIT_TOL = 1e-4
TOL = 1e-5
RUN_REL_TOL = 1e-4

IMPLS = ["reference", "auto"]


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


def _models(impl="reference", seed=0, **overrides):
    jcfg = jbert.tiny_bert(dtype=jnp.float32, attention_impl="reference",
                           **overrides)
    jparams = jbert.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = tbert.tiny_bert(dtype=torch.float32, attention_impl=impl,
                           **overrides)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(seed, b=3, s=20, n_classes=3):
    """Tokens, labels and an attention mask padding each row's tail."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (b, s), dtype=np.int32)
    labels = rng.integers(0, n_classes, (b,), dtype=np.int32)
    mask = np.ones((b, s), np.int32)
    for row, pad in enumerate(rng.integers(0, s // 2, b)):
        mask[row, s - pad:] = 0
    return tokens, labels, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_classify_and_mlm_logits_match_reference(impl):
    """``encode`` and ``classify`` with and without a padding mask (padded
    keys still attended, padded rows of each attention output zeroed, a
    mask-weighted mean pool) and ``mlm_logits``."""
    jcfg, jparams, tcfg, tparams = _models(impl, seed=1)
    tokens, _, mask = _batch(2)
    assert mask.min() == 0
    tt, tm = _t(tokens, mask)
    with torch.no_grad():
        for m_j, m_t in ((None, None), (jnp.asarray(mask), tm)):
            hidden = jbert.encode(jcfg, jparams, jnp.asarray(tokens), m_j)
            got = tbert.encode(tcfg, tparams, tt, m_t)
            assert np.abs(np.asarray(hidden) - got.numpy()).max() <= LOGIT_TOL
            logits = jbert.classify(jcfg, jparams, jnp.asarray(tokens), m_j)
            got = tbert.classify(tcfg, tparams, tt, m_t)
            assert got.shape == (3, 3)
            assert np.abs(np.asarray(logits) - got.numpy()).max() \
                <= LOGIT_TOL
        mlm = jbert.mlm_logits(jcfg, jparams, jnp.asarray(tokens),
                               jnp.asarray(mask))
        got = tbert.mlm_logits(tcfg, tparams, tt, tm)
    assert got.dtype == torch.float32 and got.shape == (3, 20, 512)
    assert np.abs(np.asarray(mlm) - got.numpy()).max() <= LOGIT_TOL


def _grads(loss_fn, params):
    params = ttrain.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), params)
    loss, metrics = loss_fn(params)
    loss.backward()
    # a leaf the loss does not reach gets zeros, as jax.grad gives it
    grads = ttrain.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, params)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("impl,remat", [("reference", False),
                                        ("auto", False), ("auto", True)])
def test_losses_and_grads_match_reference(impl, remat):
    """``classification_loss`` with a mask and ``mlm_loss``: loss, metrics
    and every leaf's gradient against ``jax.grad`` (per-layer remat
    changes nothing)."""
    jcfg, jparams, tcfg, tparams = _models(impl, seed=3)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tokens, labels, mask = _batch(4)
    targets = np.random.default_rng(5).integers(0, 512, tokens.shape,
                                                dtype=np.int32)
    mlm_mask = (np.random.default_rng(6).random(tokens.shape) < 0.3).astype(
        np.int32)
    cases = (
        (lambda p: jbert.classification_loss(
            jcfg, p, jnp.asarray(tokens), jnp.asarray(labels),
            jnp.asarray(mask)),
         lambda p: tbert.classification_loss(tcfg, p, *_t(tokens, labels,
                                                          mask))),
        (lambda p: jbert.mlm_loss(jcfg, p, jnp.asarray(tokens),
                                  jnp.asarray(targets),
                                  jnp.asarray(mlm_mask)),
         lambda p: tbert.mlm_loss(tcfg, p, *_t(tokens, targets, mlm_mask))),
    )
    for jloss, tloss in cases:
        (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
        tl, tm, tg = _grads(tloss, tparams)
        assert abs(float(jl) - tl) <= TOL
        assert set(tm) == set(jm)
        for key in jm:
            assert abs(float(jm[key]) - tm[key]) <= TOL, key
        _assert_trees_close(jg, tg, TOL)


def test_classifier_train_step_matches_reference(world_of_one):
    """Three steps of ``make_classifier_train_step`` on the port's AdamW
    against the reference's step with ``optax.adamw`` (its defaults: b2
    0.999, weight decay 1e-4): per-step loss and accuracy, then every
    param. The sharded step (``mesh=``, multi-rank parity in
    tests/test_torch_sharded_steps.py) on a size-1 ``{"data": 1, "fsdp":
    1, "tensor": 1}`` mesh places the plain trees itself and repeats the
    plain step's run bit for bit."""
    jcfg, jparams, tcfg, tparams = _models("auto", seed=7)
    lr = 1e-2
    joptim = optax.adamw(lr)
    jstep = jbert.make_classifier_train_step(jcfg, joptim)
    jstate = joptim.init(jparams)
    toptim = ttrain.AdamW(lambda count: lr, b1=0.9, b2=0.999,
                          weight_decay=1e-4)
    tstep = tbert.make_classifier_train_step(tcfg, toptim)
    tstate = toptim.init(tparams)
    for i in range(3):
        tokens, labels, mask = _batch(10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, tokens, labels, mask)
        tparams, tstate, tm = tstep(tparams, tstate, *_t(tokens, labels,
                                                         mask))
        assert set(tm) == set(jm) == {"loss", "accuracy"}
        assert abs(float(jm["loss"]) - float(tm["loss"])) \
            <= RUN_REL_TOL * abs(float(jm["loss"]))
        assert float(jm["accuracy"]) == float(tm["accuracy"])
    _assert_trees_close(jax.tree.map(np.asarray, jparams),
                        params_to_numpy(tparams), RUN_REL_TOL)
    from torch.distributed.tensor import DTensor

    from mlrun_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "fsdp": 1, "tensor": 1}, "cpu")
    _, _, _, mparams = _models("auto", seed=7)
    moptim = ttrain.AdamW(lambda count: lr, b1=0.9, b2=0.999,
                          weight_decay=1e-4)
    mstep = tbert.make_classifier_train_step(tcfg, moptim, mesh)
    mstate = moptim.init(mparams)
    _, _, _, pparams = _models("auto", seed=7)
    pstate = toptim.init(pparams)
    for i in range(3):
        batch = _t(*_batch(10 + i))
        mparams, mstate, mm = mstep(mparams, mstate, *batch)
        pparams, pstate, pm = tstep(pparams, pstate, *batch)
        assert {k: float(v) for k, v in mm.items()} == \
            {k: float(v) for k, v in pm.items()}
    assert isinstance(mparams["embedding"], DTensor)
    full = ttrain.tree_map(lambda t: t.full_tensor(), mparams)
    for (name, a), (_, b) in zip(_leaves(params_to_numpy(full)),
                                 _leaves(params_to_numpy(pparams))):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture()
def world_of_one():
    """A world-size-1 gloo group of this process, left as found."""
    import torch.distributed as dist

    existed = dist.is_initialized()
    yield
    if dist.is_initialized() and not existed:
        dist.destroy_process_group()


def test_param_count_layer_norm_and_exports():
    for overrides in ({}, {"n_classes": 5}):
        jcfg = jbert.bert_base(**overrides)
        tcfg = tbert.bert_base(**overrides)
        assert tcfg.param_count() == jcfg.param_count()
    tcfg = tbert.tiny_bert(dtype=torch.float32)
    params = tbert.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in ttrain.tree_leaves(params)) \
        == tcfg.param_count()
    assert params["classifier_b"].dtype == torch.float32
    rng = np.random.default_rng(8)
    x, scale, bias = (rng.standard_normal(shape).astype(np.float32) * 3
                      for shape in ((4, 7, 33), (33,), (33,)))
    want = jbert.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), 1e-12)
    got = tbert.layer_norm(*_t(x, scale, bias), 1e-12)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= TOL
    # BERT's verbs at package level, as the reference exports them
    for name in ("BertConfig", "bert_base", "tiny_bert", "encode", "classify",
                 "mlm_logits", "classification_loss", "mlm_loss"):
        assert getattr(tmodels, name) is getattr(tbert, name)


def test_converter_carries_the_bert_tree():
    """``params_from_numpy`` / ``params_to_numpy`` carry the reference's
    bert tree (``layers``, the float32 classifier bias) across unchanged: bf16 leaves stay bf16 (exactly,
    through float32), float32 leaves float32, an int32 leaf int32."""
    tree = jax.tree.map(np.asarray, jbert.init_params(jbert.tiny_bert(), jax.random.PRNGKey(0)))
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
