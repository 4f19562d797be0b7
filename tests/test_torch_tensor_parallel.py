"""Training on many devices, second half (item 7, entry 1): the ``tensor``
axis and the per-layer ``fsdp`` gather of the port's sharded step
(mlrun_tpu_torch/parallel/tensor.py) against the JAX package. Gloo ranks
(tests/torch_ranks.py) train the tiny float32 model on ``{"tensor": 2}``,
``{"fsdp": 2, "tensor": 2}`` and ``{"fsdp": 4}`` from the reference
Trainer's init on the same sub-mesh of the 8 virtual CPU devices
(tests/conftest.py), on the same batches.

Tolerances (tests/test_torch_parallel.py's): per-step loss,
accuracy, tokens and grad norm 1e-4 relative (``RUN_REL_TOL``), params
after 3 steps 1e-4 absolute (``PARAM_TOL``): the two sides sum the tensor
ranks' partials and the batch shards' gradients in different orders. The
rank-local halves of one layer, summed in one process, match the
unsharded layer's output and gradients within 1e-5 of each tensor's
largest element (float32 summation order only).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.ops.rotary import rope_table
from mlrun_tpu_torch.parallel.tensor import check_divisible
from mlrun_tpu_torch.training import data as tdata
from tests.torch_ranks import run_ranks

RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
HALVES_TOL = 1e-5
STEPS = 3
SHAPES = ({"tensor": 2}, {"fsdp": 2, "tensor": 2}, {"fsdp": 4})
LORA_SHAPE = {"data": 2, "fsdp": 2}
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
             weight_decay=0.1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def _key(shape):
    return ",".join(f"{a}={n}" for a, n in shape.items())


def _reference(shape):
    jt = jtrain.Trainer(jllama.tiny_llama(dtype=jnp.float32,
                                          attention_impl="reference"),
                        jtrain.TrainConfig(**dict(TRAIN, mesh_shape=shape)))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    jt.fit(jdata.synthetic_token_stream(8, 32, 512, seed=1), STEPS,
           log_every=1, prefetch=0, defer_metrics=False)
    return jt, init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape key: (reference Trainer, the port's ranks' results)}; every
    shape starts from the same reference init (seed 0). Four gloo ranks
    run every shape, {"tensor": 2} on ranks 0-1 alone."""
    stream = tdata.synthetic_token_stream(8, 32, 512, seed=1)
    batches = [next(stream) for _ in range(STEPS)]
    refs = {_key(shape): _reference(shape) for shape in SHAPES}
    init = refs[_key(SHAPES[0])][1]
    for _, other in refs.values():
        for (_, a), (_, b) in zip(_leaves(init), _leaves(other)):
            np.testing.assert_array_equal(a, b)
    lora_ref = jtrain.Trainer(
        jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference"),
        jtrain.TrainConfig(**dict(TRAIN, mesh_shape=LORA_SHAPE, lora_rank=4,
                                  lora_alpha=8.0)))
    lora_ref.init(0)
    lora = jax.tree.map(np.asarray, lora_ref.state.lora)
    lora_ref.fit(jdata.synthetic_token_stream(8, 32, 512, seed=1), STEPS,
                 log_every=1, prefetch=0, defer_metrics=False)
    ranks = run_ranks("tensor_parallel", 4, tmp_path_factory.mktemp("tp"),
                      init=init, batches=batches, shapes=list(SHAPES),
                      lora=lora)
    out = {_key(shape): (refs[_key(shape)][0], [
        dict(r[_key(shape)], jax_imported=r["jax_imported"])
        for r in ranks if _key(shape) in r]) for shape in SHAPES}
    out["lora"] = (lora_ref, [dict(r["lora"], jax_imported=r["jax_imported"])
                              for r in ranks])
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_losses_and_norms_match_reference(runs, shape):
    jt, ranks = runs[_key(shape)]
    assert len(ranks) == math.prod(shape.values())
    for out in ranks:
        assert [m["step"] for m in out["history"]] == [1, 2, 3]
        for jm, tm in zip(jt.metrics_history, out["history"]):
            for key in ("loss", "grad_norm", "accuracy", "tokens"):
                assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * max(
                    abs(jm[key]), 1e-6), (key, jm[key], tm[key])


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_params_match_reference(runs, shape):
    jt, ranks = runs[_key(shape)]
    ref = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for out in ranks:
        ours = dict(_leaves(out["params"]))
        assert ours.keys() == ref.keys()
        for path, value in ours.items():
            assert np.abs(value - ref[path]).max() <= PARAM_TOL, path


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_each_rank_holds_its_slice_of_the_reference_params(runs, shape):
    """Rank r sits at the row-major mesh coordinate of r; its local shard
    of every leaf is the reference's shard on the device at that
    coordinate (same shape, values within PARAM_TOL). A tensor rank's
    gradient of a sharded leaf is its shard: the update kept the shapes."""
    jt, ranks = runs[_key(shape)]
    devices = jt.mesh.devices
    leaves = dict(_leaves(jt.state.params))
    for rank, out in enumerate(ranks):
        coordinate = tuple(out["coordinate"])
        assert coordinate == np.unravel_index(rank, tuple(shape.values()))
        device = devices[coordinate]
        for path, shard in _leaves(out["shards"]):
            ref = next(s for s in leaves[path].addressable_shards
                       if s.device == device)
            ref = np.asarray(ref.data, np.float32)
            assert shard.shape == ref.shape, path
            assert np.abs(shard - ref).max() <= PARAM_TOL, path
    tensor = shape.get("tensor", 1)
    fsdp = shape.get("fsdp", 1)
    layers = ranks[0]["shards"]["layers"]
    assert layers["wq"].shape == (2, 128 // fsdp, 128 // tensor)
    assert layers["wk"].shape == (2, 128 // fsdp, 64 // tensor)
    assert layers["wo"].shape == (2, 128 // tensor, 128 // fsdp)
    assert layers["w_down"].shape == (2, 256 // tensor, 128 // fsdp)
    assert layers["attn_norm_scale"].shape == (2, 128)


def test_per_layer_gather_holds_one_layer_at_a_time(runs):
    """On {"fsdp": 4} every layer leaf is gathered inside its layer and
    dropped after it: the gathered layer leaves alive at any gather (the
    forward's, and the backward's gathers again) never exceed one layer's
    seven projections, with and without remat. Without remat the
    backward gathers each weight once more where it reads it (28 gathers
    a step); with remat the checkpoint's recompute does (also 28). The
    results are the reference's either way."""
    jt, ranks = runs[_key({"fsdp": 4})]
    one_layer = 4 * (128 * 128 * 2 + 128 * 64 * 2 + 3 * 128 * 256)
    for out in ranks:
        for run in (out, out["remat"]):
            assert run["gathered_peak_bytes"] == one_layer
            assert run["gathers"] == STEPS * 28
        for jm, tm in zip(jt.metrics_history, out["remat"]["history"]):
            assert abs(jm["loss"] - tm["loss"]) <= RUN_REL_TOL * jm["loss"]


def test_lora_on_a_mesh_gathers_layer_by_layer_too(runs):
    """A rank-4 adapter on {"data": 2, "fsdp": 2}: the frozen base's
    layers are gathered layer by layer without gradients and the
    adapter's gradients reduced: losses, norms and the adapter match the
    reference Trainer's, and the base stays its init."""
    jt, ranks = runs["lora"]
    ref = dict(_leaves(jax.tree.map(np.asarray, jt.state.lora)))
    base = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    assert len(ranks) == 4
    for out in ranks:
        for jm, tm in zip(jt.metrics_history, out["history"]):
            for key in ("loss", "grad_norm"):
                assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * jm[key], key
        for path, value in _leaves(out["lora"]):
            assert np.abs(value - ref[path]).max() <= PARAM_TOL, path
        for path, value in _leaves(out["params"]):
            np.testing.assert_array_equal(value, base[path], path)


def test_ranks_import_no_jax(runs):
    assert not any(out["jax_imported"] for _, ranks in runs.values()
                   for out in ranks)


# -- the rank-local halves in one process ------------------------------------

def _split(lp, t, tensor):
    """Rank t's shards of one layer's weights on a tensor axis of size
    ``tensor``: column-split q/k/v/gate/up, row-split wo/w_down."""
    out = {}
    for name, w in lp.items():
        if name in ("wq", "wk", "wv", "w_gate", "w_up"):
            n = w.shape[-1] // tensor
            out[name] = w[:, t * n:(t + 1) * n]
        elif name in ("wo", "w_down"):
            n = w.shape[0] // tensor
            out[name] = w[t * n:(t + 1) * n]
        else:
            out[name] = w
    return out


def test_rank_local_halves_sum_to_the_unsharded_layer():
    """Each tensor rank's attention half and MLP half on its shards,
    summed in rank order where the all-reduce stands, give the unsharded
    layer's output, and one backward through that graph gives the
    unsharded layer's gradients, each shard's the slice of the full
    one."""
    params = jax.tree.map(np.asarray, jllama.init_params(
        jllama.tiny_llama(dtype=jnp.float32), jax.random.PRNGKey(3)))
    config = tllama.tiny_llama(dtype=torch.float32)
    lp = {k: torch.from_numpy(v[0].copy()) for k, v in
          params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, 128)).astype(np.float32))
    cos, sin = rope_table(torch.arange(16), config.head_dim,
                          config.rope_theta)
    full = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
    xf = x.clone().requires_grad_(True)
    out_full = tllama._layer_body(config, xf, full, cos, sin)
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        out_full.shape).astype(np.float32))
    out_full.backward(dout)
    tensor = 2
    check_divisible(config, tensor)
    xs = x.clone().requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
    shards = [_split(leaves, t, tensor) for t in range(tensor)]
    partial = sum(tllama.attention_half(config, xs, shards[t], cos, sin)
                  for t in range(tensor))
    mid = xs + partial
    out = mid + sum(tllama.mlp_half(config, mid, shards[t])
                    for t in range(tensor))
    out.backward(dout)

    def close(a, b):
        return (a - b).abs().max().item() <= HALVES_TOL * max(
            1.0, b.abs().max().item())

    assert close(out.detach(), out_full.detach())
    assert close(xs.grad, xf.grad)
    for name in lp:
        assert close(leaves[name].grad, full[name].grad), name
        for t in range(tensor):
            assert close(_split({name: leaves[name].grad}, t, tensor)[name],
                         _split({name: full[name].grad}, t, tensor)[name])


def test_kv_heads_must_divide_the_tensor_axis():
    """GQA pairs each rank's q heads with its own kv heads: a tensor axis
    that does not divide the kv heads raises, naming both numbers."""
    config = tllama.tiny_llama()
    check_divisible(config, 1)
    check_divisible(config, 2)
    with pytest.raises(ValueError, match=r"n_kv_heads \(2\).*tensor axis "
                                         r"\(4\)"):
        check_divisible(config, 4)
    with pytest.raises(ValueError, match=r"n_heads \(4\).*\(8\)"):
        check_divisible(tllama.tiny_llama(n_kv_heads=8), 8)
