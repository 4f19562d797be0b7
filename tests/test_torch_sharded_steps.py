"""The families' sharded steps, LoRA on a ``tensor`` axis and HF weights
placed on a mesh (item 7, entries 4 and 6) against the JAX package. Four
gloo ranks (tests/torch_ranks.py) run:

- BERT's classifier on ``{"data": 2, "tensor": 2}`` and ViT on
  ``{"fsdp": 4}``, 3 steps from the reference's init (plain trees, placed
  by the step as the reference's jit places them), against the
  reference's sharded steps on the same meshes of the 8 virtual CPU
  devices (tests/conftest.py): per-step metrics at ``RUN_REL_TOL``
  (tests/test_torch_bert.py's and tests/test_torch_vit.py's 1e-4), every
  param after the run at ``RUN_REL_TOL`` for ViT and at ``ADAM_EPS_TOL``
  for BERT: its embedding rows of tokens seen in one batch half get
  near-eps gradients that Adam amplifies, and the reference's own
  sharded run sits 1.93e-4 from its unsharded run there (every other
  leaf within 6e-5);
- T5 on ``{"fsdp": 2, "tensor": 2}`` held as tests/test_torch_t5.py holds
  it since its steps were steadied: each step restarts from the
  reference's state (params and moments), every gradient at ``TOL``
  1e-5 against ``jax.grad``, the loss and grad norm at ``RUN_REL_TOL``,
  the params after the update at ``ADAM_EPS_TOL`` 2e-3. Adam's first
  update is ``g / (|g| + eps)``: a near-eps gradient's float32 noise can
  flip it, moving a param by up to 2 lr, and the reference's own sharded
  step lands 3.0e-3 from its unsharded step there (``encoder/w_down``;
  6.4e-6 and 5.3e-6 on steps 2-3). Step 1's params are held at
  ``FIRST_UPDATE_TOL`` = 2 lr;
- a rank-4 LoRA adapter on ``{"tensor": 2}`` and ``{"fsdp": 2, "tensor":
  2}`` against the reference Trainer (tests/test_torch_tensor_parallel.py's
  bounds: per-step metrics 1e-4 relative, adapter leaves 1e-4 absolute),
  the base params bit-equal to their start;
- ``load_hf_weights_into_llama(shardings=)`` onto ``{"fsdp": 2}``: every
  gathered leaf bit-equal to a load on the device, each rank holding half.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mlrun_tpu.models import bert as jbert
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import t5 as jt5
from mlrun_tpu.models import vit as jvit
from mlrun_tpu.parallel import mesh as jmesh
from mlrun_tpu.parallel.sharding import tree_shardings
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.training import data as tdata
from tests.test_torch_bert import _batch as bert_batch
from tests.test_torch_hf import _hf_model, _save
from tests.test_torch_t5 import _batch as t5_batch
from tests.test_torch_t5 import _models as t5_models
from tests.test_torch_vit import _images
from tests.test_torch_vit import _models as vit_models
from tests.torch_ranks import LORA_SHAPES, run_ranks

TOL = 1e-5
RUN_REL_TOL = 1e-4
ADAM_EPS_TOL = 2e-3
PARAM_TOL = 1e-4
STEPS = 3
LR = 1e-2
FIRST_UPDATE_TOL = 2 * LR
BERT_MESH = {"data": 2, "tensor": 2}
VIT_MESH = {"fsdp": 4}
T5_MESH = {"fsdp": 2, "tensor": 2}
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
             weight_decay=0.1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(ref, ours, tol, relative=False):
    ref, ours = dict(_leaves(ref)), dict(_leaves(ours))
    assert ref.keys() == ours.keys()
    for path, value in ref.items():
        scale = max(np.abs(value).max(), 1e-6) if relative else 1.0
        diff = np.abs(ours[path] - value).max()
        assert diff <= tol * scale, (path, diff)


def _key(shape):
    return ",".join(f"{a}={n}" for a, n in shape.items())


def _encoder_run(jstep, jparams, batches):
    joptim_state = optax.adamw(LR).init(jparams)
    history = []
    for batch in batches:
        jparams, joptim_state, metrics = jstep(jparams, joptim_state, *batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return history, _numpy(jparams)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """The reference's runs and the ranks' results of the three
    families."""
    jcfg, jparams, _, _ = _bert_models()
    bert_batches = [bert_batch(10 + i, b=4) for i in range(STEPS)]
    bert_init = _numpy(jparams)
    mesh = jmesh.make_mesh(BERT_MESH)
    bert_ref = _encoder_run(jbert.make_classifier_train_step(
        jcfg, optax.adamw(LR), mesh), jparams, bert_batches)

    vcfg, vparams, _, _ = vit_models(seed=5)
    vit_batches = [_images(10 + i, b=4) for i in range(STEPS)]
    vit_init = _numpy(vparams)
    mesh = jmesh.make_mesh(VIT_MESH)
    vit_ref = _encoder_run(
        jvit.make_train_step(vcfg, optax.adamw(LR), mesh=mesh),
        jax.device_put(vparams, tree_shardings(vparams, mesh)), vit_batches)

    tcfg, tparams, _, _ = t5_models(seed=6)
    mesh = jmesh.make_mesh(T5_MESH)
    joptim = optax.adamw(LR)
    jstep = jt5.make_train_step(tcfg, joptim, mesh=mesh)
    jstate = joptim.init(tparams)
    t5_batches, states, t5_ref = [], [], []
    for i in range(STEPS):
        ids, _, dec, targets, _ = t5_batch(10 + i, b=4)
        t5_batches.append((ids, dec, targets))
        adam = jstate[0]
        states.append((_numpy(tparams), _numpy(adam.mu), _numpy(adam.nu),
                       int(adam.count)))
        grads = jax.grad(lambda p: jt5.seq2seq_loss(
            tcfg, p, ids, dec, targets)[0])(jax.tree.map(jnp.asarray,
                                                         states[-1][0]))
        tparams, jstate, metrics = jstep(tparams, jstate, ids, dec, targets)
        t5_ref.append(({k: float(v) for k, v in metrics.items()},
                       _numpy(tparams), _numpy(grads)))
    ranks = run_ranks(
        "family_steps", 4, tmp_path_factory.mktemp("families"),
        bert={"init": bert_init, "batches": bert_batches},
        vit={"init": vit_init, "batches": vit_batches},
        t5={"states": states, "batches": t5_batches})
    return {"bert": bert_ref, "vit": vit_ref, "t5": t5_ref, "ranks": ranks}


def _bert_models():
    from tests.test_torch_bert import _models

    return _models("auto", seed=7)


@pytest.mark.parametrize("family, param_tol", [("bert", ADAM_EPS_TOL),
                                               ("vit", RUN_REL_TOL)])
def test_encoder_sharded_steps_match_reference(families, family, param_tol):
    history, params = families[family]
    for out in families["ranks"]:
        assert not out["jax_imported"]
        ours = out[family]
        assert len(ours["history"]) == STEPS
        for jm, tm in zip(history, ours["history"]):
            assert set(jm) == set(tm)
            for key in jm:
                assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * max(
                    abs(jm[key]), 1e-6), (key, jm[key], tm[key])
        _close(params, ours["params"], param_tol)


@pytest.mark.parametrize("family, shape", [("bert", BERT_MESH),
                                           ("vit", VIT_MESH)])
def test_encoder_params_stay_placed_by_the_shared_rules(families, family,
                                                        shape):
    """The step placed the plain trees by the shared rules: each rank's
    local shard is the slice of the full param at its coordinate (a
    leaf sharded over fsdp or tensor holds 1/n of the rows there)."""
    from mlrun_tpu_torch.parallel.sharding import spec_for_path

    sizes = dict(shape)
    for rank, out in enumerate(families["ranks"]):
        ours = out[family]
        assert tuple(ours["coordinate"]) == np.unravel_index(
            rank, tuple(shape.values()))
        full = dict(_leaves(ours["params"]))
        split = 0
        for path, shard in _leaves(ours["shards"]):
            spec = spec_for_path(path, ndim=shard.ndim)
            want = list(full[path].shape)
            for dim, axis in enumerate(spec):
                if axis in sizes and sizes[axis] > 1:
                    want[dim] //= sizes[axis]
                    split += 1
            assert list(shard.shape) == want, path
        assert split > 0


def test_t5_sharded_steps_match_reference(families):
    for out in families["ranks"]:
        for i, ((jm, jparams, jgrads), ours) in enumerate(
                zip(families["t5"], out["t5"])):
            names = [name for name, _ in _leaves(jgrads)]
            _close(jgrads, dict(zip(names, ours["grads"])), TOL)
            assert set(ours["metrics"]) == set(jm) == {"loss", "accuracy",
                                                       "grad_norm"}
            for key in ("loss", "grad_norm"):
                assert abs(jm[key] - ours["metrics"][key]) \
                    <= RUN_REL_TOL * abs(jm[key]), (i, key)
            _close(jparams, ours["params"],
                   FIRST_UPDATE_TOL if i == 0 else ADAM_EPS_TOL)


@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory):
    stream = tdata.synthetic_token_stream(8, 32, 512, seed=1)
    batches = [next(stream) for _ in range(STEPS)]
    refs, init, lora = {}, None, None
    for shape in LORA_SHAPES:
        jt = jtrain.Trainer(
            jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference"),
            jtrain.TrainConfig(**dict(TRAIN, mesh_shape=shape, lora_rank=4,
                                      lora_alpha=8.0)))
        jt.init(0)
        if init is None:
            init = jax.tree.map(np.asarray, jt.state.params)
            lora = jax.tree.map(np.asarray, jt.state.lora)
        jt.fit(jdata.synthetic_token_stream(8, 32, 512, seed=1), STEPS,
               log_every=1, prefetch=0, defer_metrics=False)
        refs[_key(shape)] = jt
    hf_dir = _save(_hf_model(), tmp_path_factory.mktemp("hf"), "single")
    ranks = run_ranks("lora_tensor", 4, tmp_path_factory.mktemp("lora"),
                      init=init, lora=lora, batches=batches, hf_dir=hf_dir)
    return {"refs": refs, "ranks": ranks, "init": init}


@pytest.mark.parametrize("shape", LORA_SHAPES, ids=_key)
def test_lora_on_a_tensor_axis_matches_reference(lora_runs, shape):
    jt = lora_runs["refs"][_key(shape)]
    ranks = [r[_key(shape)] for r in lora_runs["ranks"] if _key(shape) in r]
    assert len(ranks) == math.prod(shape.values())
    ref_lora = dict(_leaves(jax.tree.map(np.asarray, jt.state.lora)))
    for out in ranks:
        for jm, tm in zip(jt.metrics_history, out["history"]):
            for key in ("loss", "grad_norm", "accuracy", "tokens"):
                assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * max(
                    abs(jm[key]), 1e-6), (key, jm[key], tm[key])
        ours = dict(_leaves(out["lora"]))
        assert ours.keys() == ref_lora.keys()
        for path, value in ours.items():
            assert np.abs(value - ref_lora[path]).max() <= PARAM_TOL, path


@pytest.mark.parametrize("shape", LORA_SHAPES, ids=_key)
def test_lora_base_params_stay_bit_equal(lora_runs, shape):
    init = dict(_leaves(lora_runs["init"]))
    for r in lora_runs["ranks"]:
        if _key(shape) not in r:
            continue
        for path, value in _leaves(r[_key(shape)]["params"]):
            np.testing.assert_array_equal(value, init[path], err_msg=path)


def test_hf_weights_placed_on_an_fsdp_mesh(lora_runs):
    """shardings= (the port's tree_shardings placements) onto {"fsdp": 2}:
    every gathered leaf bit-equal to a load on the device; each rank holds
    half of the sharded leaves' elements."""
    hf = [r["hf"] for r in lora_runs["ranks"] if "hf" in r]
    assert len(hf) == 2
    for out in hf:
        assert out["bit_equal"] and all(out["bit_equal"])
        assert out["local_numel"] < out["numel"]
    assert sum(o["local_numel"] for o in hf) > hf[0]["numel"]
