"""The port's ViT family (mlrun_tpu_torch/models/vit.py) against the JAX
package on the CPU, at ``tiny_vit`` size (32 x 32 images, 8 x 8 patches:
17 tokens, not a multiple of any tile) in float32 with TF32 off. Params
are the reference's ``init_params`` converted with ``params_from_numpy``;
images come from numpy seeds. The reference runs its plain attention (as
its own tests do on the CPU); the port runs both its plain attention and
its flash route's plain version (``auto``: the kernels' path on CUDA).

Tolerances (the Llama parity tests'): patchify exactly; encodings and
logits 1e-4 absolute; loss, accuracy and gradients 1e-5; a 3-step run
1e-4 relative (loss and grad norm; the params after it 1e-4 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlrun_tpu.models import vit as jvit
from mlrun_tpu_torch import models as tmodels
from mlrun_tpu_torch.models import vit as tvit
from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from mlrun_tpu_torch.training import train as ttrain

LOGIT_TOL = 1e-4
TOL = 1e-5
RUN_REL_TOL = 1e-4


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
    jcfg = jvit.tiny_vit(dtype=jnp.float32, **overrides)
    jparams = jvit.init_params(jcfg, jax.random.PRNGKey(seed))
    # the reference's init leaves cls_token and the biases at zero; give
    # them values so their paths are held too
    rng = np.random.default_rng(seed + 100)
    jparams = dict(jparams)
    for name in ("cls_token", "patch_bias"):
        jparams[name] = jnp.asarray(
            rng.standard_normal(jparams[name].shape).astype(np.float32))
    tcfg = tvit.tiny_vit(dtype=torch.float32, attention_impl=impl,
                         **overrides)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _images(seed, b=3, size=32):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (b,), dtype=np.int32)
    return images, labels


def test_patchify_matches_reference_exactly():
    """Every patch in the reference's order, each flattened (row, column,
    channel), bit for bit, on a non-square grid as well."""
    cfg_j, cfg_t = jvit.tiny_vit(), tvit.tiny_vit()
    for shape in ((2, 32, 32, 3), (1, 16, 40, 3)):
        images = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        want = np.asarray(jvit.patchify(cfg_j, jnp.asarray(images)))
        got = tvit.patchify(cfg_t, torch.from_numpy(images)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["reference", "auto"])
def test_encode_and_classify_match_reference(impl):
    jcfg, jparams, tcfg, tparams = _models(impl, seed=1)
    images, _ = _images(2)
    with torch.no_grad():
        enc = tvit.encode(tcfg, tparams, torch.from_numpy(images))
        logits = tvit.classify(tcfg, tparams, torch.from_numpy(images))
    assert enc.shape == (3, 17, 64) and logits.dtype == torch.float32
    want = jvit.encode(jcfg, jparams, jnp.asarray(images))
    assert np.abs(np.asarray(want) - enc.numpy()).max() <= LOGIT_TOL
    want = jvit.classify(jcfg, jparams, jnp.asarray(images))
    assert np.abs(np.asarray(want) - logits.numpy()).max() <= LOGIT_TOL


@pytest.mark.parametrize("impl,remat", [("reference", False),
                                        ("auto", False), ("auto", True)])
def test_loss_and_grads_match_reference(impl, remat):
    """``loss_fn``: loss, accuracy and every leaf's gradient against
    ``jax.grad``; per-layer remat (ViT's default) changes nothing."""
    jcfg, jparams, tcfg, tparams = _models(impl, seed=3)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    images, labels = _images(4)

    def jloss(p):
        return jvit.loss_fn(jcfg, p, jnp.asarray(images),
                            jnp.asarray(labels))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = ttrain.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), tparams)
    tl, tm = tvit.loss_fn(tcfg, tparams, torch.from_numpy(images),
                          torch.from_numpy(labels))
    tl.backward()
    assert abs(float(jl) - tl.item()) <= TOL
    for key in ("loss", "accuracy"):
        assert abs(float(jm[key]) - tm[key].item()) <= TOL, key
    _assert_trees_close(jg, ttrain.tree_map(lambda t: t.grad, tparams), TOL)


def test_train_step_matches_reference():
    """Three steps of ``make_train_step`` on the port's AdamW against the
    reference's step with ``optax.adamw`` (with the port's default remat,
    on): per-step loss and grad norm, then every param."""
    jcfg, jparams, tcfg, tparams = _models("auto", seed=5)
    tcfg = dataclasses.replace(tcfg, remat=True)
    lr = 1e-2
    joptim = optax.adamw(lr)
    jstep = jvit.make_train_step(jcfg, joptim)
    jstate = joptim.init(jparams)
    toptim = ttrain.AdamW(lambda count: lr, b1=0.9, b2=0.999,
                          weight_decay=1e-4)
    tstep = tvit.make_train_step(tcfg, toptim)
    tstate = toptim.init(tparams)
    for i in range(3):
        images, labels = _images(10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, images, labels)
        tparams, tstate, tm = tstep(tparams, tstate,
                                    torch.from_numpy(images),
                                    torch.from_numpy(labels))
        assert set(tm) == set(jm) == {"loss", "accuracy", "grad_norm"}
        for key in ("loss", "grad_norm"):
            assert abs(float(jm[key]) - float(tm[key])) \
                <= RUN_REL_TOL * abs(float(jm[key])), key
    _assert_trees_close(jax.tree.map(np.asarray, jparams),
                        params_to_numpy(tparams), RUN_REL_TOL)


def test_param_count_flops_and_exports():
    for name in ("vit_b16", "vit_l16", "tiny_vit"):
        jcfg, tcfg = getattr(jvit, name)(), getattr(tvit, name)()
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.flops_per_image() == jcfg.flops_per_image()
        assert (tcfg.n_patches, tcfg.patch_dim, tcfg.head_dim) \
            == (jcfg.n_patches, jcfg.patch_dim, jcfg.head_dim)
    assert tvit.vit_b16().n_patches + 1 == 197
    tcfg = tvit.tiny_vit(dtype=torch.float32)
    params = tvit.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in ttrain.tree_leaves(params)) \
        == tcfg.param_count()
    # vit's verbs stay namespaced; its configs are exported
    assert tmodels.vit is tvit and tmodels.ViTConfig is tvit.ViTConfig
    assert tmodels.vit_b16 is tvit.vit_b16


def test_converter_carries_the_vit_tree():
    """``params_from_numpy`` / ``params_to_numpy`` carry the reference's
    vit tree (``layers``, the float32 head bias) across unchanged: bf16 leaves stay bf16 (exactly,
    through float32), float32 leaves float32, an int32 leaf int32."""
    tree = jax.tree.map(np.asarray, jvit.init_params(jvit.tiny_vit(), jax.random.PRNGKey(0)))
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
