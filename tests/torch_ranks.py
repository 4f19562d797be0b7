"""Multi-rank runs of the port for the parity tests: a spawned process per
rank, joined over gloo through a ``FileStore`` under the test's temporary
directory, each rank on one CPU thread. The rank functions below import
the port and never JAX: the reference runs in the test process, which
hands its inputs (numpy) to the ranks and compares what they return.

``run_ranks`` waits at most ``timeout`` seconds for all ranks; a rank
still running then is killed and the test fails, as it does with a
rank's traceback when one raises.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
import traceback
from datetime import timedelta

import pytest

RANK_TIMEOUT_S = 60


def run_ranks(name: str, world: int, directory, timeout: float =
              RANK_TIMEOUT_S, **kwargs) -> list:
    """Run ``<this module>.<name>(rank, world, **kwargs)`` on ``world``
    spawned ranks; returns each rank's result."""
    import torch

    directory = str(directory)
    context = multiprocessing.get_context("spawn")
    procs = [context.Process(target=_child,
                             args=(name, rank, world, directory, kwargs))
             for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    if hung:
        pytest.fail(f"{name}: ranks {hung} still running after {timeout} s "
                    "(killed)")
    for rank, proc in enumerate(procs):
        if proc.exitcode != 0:
            err = os.path.join(directory, f"rank{rank}.err")
            detail = open(err).read() if os.path.exists(err) else ""
            pytest.fail(f"{name}: rank {rank} exited {proc.exitcode}\n"
                        f"{detail}")
    return [torch.load(os.path.join(directory, f"rank{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def _child(name, rank, world, directory, kwargs):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(directory, "store"),
                                         world),
            rank=rank, world_size=world, timeout=timedelta(seconds=45))
        result = globals()[name](rank, world, **kwargs)
        result["jax_imported"] = "jax" in sys.modules
        torch.save(result, os.path.join(directory, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as fp:
            fp.write(traceback.format_exc())
        sys.exit(1)


# -- helpers ------------------------------------------------------------------

def _numpy(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {key: _numpy(value) for key, value in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().float().numpy().copy()


def _shards(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {key: _shards(value) for key, value in tree.items()}
    assert isinstance(tree, DTensor)
    return tree.to_local().detach().float().numpy().copy()


def _tiny(**overrides):
    import torch

    from mlrun_tpu_torch.models.llama import tiny_llama

    return tiny_llama(dtype=torch.float32, **overrides)


def _train_config(**kw):
    from mlrun_tpu_torch.training import TrainConfig

    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                weight_decay=0.1)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(init, config=None, **kw):
    from mlrun_tpu_torch.models.convert import params_from_numpy
    from mlrun_tpu_torch.training import Trainer

    trainer = Trainer(config or _tiny(), _train_config(**kw), device="cpu")
    trainer.init(params=params_from_numpy(init, "cpu"))
    return trainer


def _stop_on(rank: int, stop_rank: int, stop_step: int):
    """A callback voting to stop at ``stop_step`` on ``stop_rank`` only."""
    from mlrun_tpu_torch.frameworks._common import Callback

    class Stop(Callback):
        def on_step_end(self, step, metrics):
            return not (rank == stop_rank and step == stop_step)

    return Stop()


# -- rank functions -------------------------------------------------------------

def data_fsdp(rank, world, init, batches, ckpt_dir):
    """Trainer.fit for len(batches) steps on {"data": 2, "fsdp": 2};
    make_loss_step(mesh=) against the same step without a mesh; an early
    stop voted on one rank; a preemption latched on one rank; evaluate
    over the mesh against no mesh."""
    import torch

    from mlrun_tpu_torch.frameworks._common import Callback
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.models.convert import params_from_numpy
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.parallel.sharding import shard_pytree
    from mlrun_tpu_torch.training.train import make_loss_step, make_optimizer

    shape = {"data": 2, "fsdp": 2}
    trainer = _trainer(init, mesh_shape=shape)
    trainer.fit(iter(batches), len(batches), log_every=1, prefetch=0,
                defer_metrics=False)
    out = {"history": trainer.metrics_history,
           "coordinate": trainer.mesh.get_coordinate(),
           "shards": _shards(trainer.state.params),
           "params": _numpy(trainer.state.params)}

    # make_loss_step over the mesh vs the plain step on the whole batch
    config = _tiny()
    mesh = make_mesh(shape, "cpu")

    def loss(params, tokens, targets):
        return llama.loss_fn(config, params, tokens, targets)

    runs = {}
    for key, on_mesh in (("plain", None), ("mesh", mesh)):
        optimizer = make_optimizer(_train_config())
        params = params_from_numpy(init, "cpu")
        if on_mesh is not None:
            params = shard_pytree(params, mesh)
        opt_state = optimizer.init(params)
        step = make_loss_step(loss, optimizer, on_mesh)
        losses = []
        for tokens, targets in batches[:2]:
            params, opt_state, metrics = step(
                params, opt_state, torch.from_numpy(tokens),
                torch.from_numpy(targets))
            losses.append((float(metrics["loss"]),
                           float(metrics["grad_norm"])))
        runs[key] = {"losses": losses, "params": _numpy(params)}
    out["loss_step"] = runs

    # an early stop voted on rank 1 alone, at a step off the log points:
    # every rank stops at the next log point, in the same step
    stopper = _trainer(init, mesh_shape=shape)
    last = stopper.fit(iter(batches * 2), 6, log_every=2, prefetch=0,
                       callbacks=[_stop_on(rank, 1, 0)])
    out["stopped"] = {"step": stopper.state.step,
                      "stopped_early": last.get("stopped_early")}

    # SIGTERM reaches rank 2 alone, during step 1: the ranks agree on the
    # latch before step 2, all save step 2 through DCP and return
    from mlrun_tpu_torch.training import CheckpointManager, PreemptionGuard

    guard = PreemptionGuard()

    class Signal(Callback):
        def on_step_end(self, step, metrics):
            if rank == 2 and step == 1:
                guard.request()
            return True

    manager = CheckpointManager(ckpt_dir)
    preempted = _trainer(init, mesh_shape=shape)
    last = preempted.fit(iter(batches * 2), 6, log_every=1, prefetch=0,
                         callbacks=[Signal()], checkpoint_manager=manager,
                         preemption_guard=guard)
    out["preempted"] = {"step": preempted.state.step,
                        "preempted": last.get("preempted"),
                        "latched": guard.requested,
                        "saved": manager._steps()}

    evals = {}
    for key, eval_shape in (("plain", None), ("mesh", shape)):
        evals[key] = auto_trainer.evaluate(
            model="tiny", model_overrides={"dtype": torch.float32},
            batch_size=8, seq_len=32, steps=2, seed=3,
            mesh_shape=eval_shape, device="cpu")
    out["evaluate"] = evals
    return out


CP_CASES = (({"seq": 4}, "ring"), ({"seq": 4}, "ulysses"),
            ({"data": 2, "seq": 2}, "ring"), ({"data": 2, "seq": 2},
                                              "ulysses"))


def context_parallel(rank, world, init, lora, tokens, targets, batches,
                     trainer_init):
    """The context-parallel loss and gradients (summed over the ranks) in
    every case of CP_CASES; the LoRA gradients through the ring; three
    steps of Trainer(context_parallel="ring") on {"seq": 4}; and LoRA
    with gradient accumulation on {"data": 2, "seq": 2}."""
    import torch
    import torch.distributed as dist

    from mlrun_tpu_torch.models.convert import params_from_numpy
    from mlrun_tpu_torch.models.llama_cp import make_context_parallel_loss
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.training.train import tree_leaves, tree_map

    config = _tiny()
    tokens_t, targets_t = torch.from_numpy(tokens), torch.from_numpy(targets)

    def grads_of(shape, impl, trained="params"):
        mesh = make_mesh(shape, "cpu")
        loss = make_context_parallel_loss(
            config, mesh, "seq", impl,
            data_axes=("data",) if "data" in shape else None)
        params = params_from_numpy(init, "cpu")
        adapter = None if trained == "params" else tree_map(
            lambda t: t.requires_grad_(True), params_from_numpy(lora, "cpu"))
        target = params if adapter is None else adapter
        for leaf in tree_leaves(target):
            leaf.requires_grad_(True)
        share, metrics = loss(params, tokens_t, targets_t, lora=adapter)
        grads = torch.autograd.grad(share, tree_leaves(target))
        for grad in grads:
            dist.all_reduce(grad)
        return {"loss": float(metrics["loss"]),
                "tokens": float(metrics["tokens"]),
                "grads": [g.numpy().copy() for g in grads]}

    out = {"cases": [grads_of(shape, impl) for shape, impl in CP_CASES],
           "lora": grads_of({"seq": 4}, "ring", trained="lora")}

    trainer = _trainer(trainer_init, context_parallel="ring",
                       seq_axis="seq", mesh_shape={"seq": 4})
    trainer.fit(iter(batches), len(batches), log_every=1, prefetch=0,
                defer_metrics=False)
    out["trainer"] = {"history": trainer.metrics_history,
                      "params": _numpy(trainer.state.params)}

    accum = _trainer(trainer_init, context_parallel="ring", seq_axis="seq",
                     mesh_shape={"data": 2, "seq": 2}, lora_rank=4,
                     grad_accum=2)
    base = _numpy(accum.state.params)
    adapter = _numpy(accum.state.lora)
    last = accum.fit(iter(batches), 2, log_every=1, prefetch=0)
    out["lora_accum"] = {"loss": last["loss"],
                         "base": (base, _numpy(accum.state.params)),
                         "lora": (adapter, _numpy(accum.state.lora))}
    return out


def sharded_checkpoint(rank, world, init, batches, ckpt_dir):
    """On {"fsdp": 2}: 4 steps saving steps 2 and 4 through DCP; a fresh
    trainer resumed from step 2 by the environment directive; no
    directive; a directive naming a step that is not there."""
    from mlrun_tpu_torch.frameworks._common.callbacks import (
        CheckpointCallback,
    )
    from mlrun_tpu_torch.training import CheckpointManager
    from mlrun_tpu_torch.training.checkpoint import (
        RESUME_CHECKPOINT_ENV,
        RESUME_STEP_ENV,
    )

    shape = {"fsdp": 2}
    manager = CheckpointManager(ckpt_dir)
    full = _trainer(init, mesh_shape=shape)
    full.fit(iter(batches), 4, log_every=1, prefetch=0,
             callbacks=[CheckpointCallback(manager, every_steps=2)])
    out = {"uninterrupted": [h["loss"] for h in full.metrics_history],
           "params": _numpy(full.state.params),
           "saved": manager._steps()}

    def fresh_run(step_env, first_batch, steps):
        os.environ.pop(RESUME_CHECKPOINT_ENV, None)
        os.environ.pop(RESUME_STEP_ENV, None)
        if step_env is not None:
            os.environ[RESUME_CHECKPOINT_ENV] = ckpt_dir
            os.environ[RESUME_STEP_ENV] = step_env
        trainer = _trainer(init, mesh_shape=shape)
        trainer.fit(iter(batches[first_batch:]), steps, log_every=1,
                    prefetch=0, checkpoint_manager=manager)
        return {"losses": [h["loss"] for h in trainer.metrics_history],
                "step": trainer.state.step,
                "steps_logged": [h["step"] for h in trainer.metrics_history],
                "goodput": trainer.goodput.summary()}

    out["resumed"] = fresh_run("2", 2, 2)
    out["no_directive"] = fresh_run(None, 0, 1)
    out["bad_step"] = fresh_run("99", 0, 1)
    return out


def _fit_record(trainer, batches):
    trainer.fit(iter(batches), len(batches), log_every=1, prefetch=0,
                defer_metrics=False)
    return {"history": trainer.metrics_history,
            "coordinate": trainer.mesh.get_coordinate(),
            "shards": _shards(trainer.state.params),
            "params": _numpy(trainer.state.params)}


def tensor_parallel(rank, world, init, batches, shapes, lora):
    """Trainer.fit for len(batches) steps on each mesh shape of
    ``shapes`` (tensor-parallel layers, per-layer fsdp gathers), each over
    the first ranks of the group that it needs; on an fsdp-only shape the
    gathers are recorded: at every gather of a layer leaf over fsdp, the
    bytes of gathered layer leaves still alive. Then a rank-4 LoRA
    adapter ``lora`` trained on {"data": 2, "fsdp": 2}."""
    import math
    import weakref

    from mlrun_tpu_torch.parallel import tensor as tp
    from mlrun_tpu_torch.parallel.mesh import make_mesh

    layer_comms = weakref.WeakSet()
    alive: list = []
    peaks: list = []
    original_init, original_gather = (tp.LayerParallel.__init__,
                                      tp.LeafComm.gather)

    def init_recording(self, mesh, layers, lora, ranks):
        original_init(self, mesh, layers, lora, ranks)
        layer_comms.update(self.layers.values())

    def gather_recording(self, local):
        out = original_gather(self, local)
        if self in layer_comms and self.gather_axes:
            alive[:] = [(ref, n) for ref, n in alive if ref() is not None]
            alive.append((weakref.ref(out), out.numel() * out.element_size()))
            peaks.append(sum(n for _, n in alive))
        return out

    out = {}
    for shape in shapes:
        key = ",".join(f"{a}={n}" for a, n in shape.items())
        record = "tensor" not in shape
        if record:
            tp.LayerParallel.__init__ = init_recording
            tp.LeafComm.gather = gather_recording
        try:
            runs = {}
            for remat in ((False, True) if record else (False,)):
                mesh = make_mesh(shape, "cpu", ranks=range(
                    math.prod(shape.values())))
                if mesh.get_coordinate() is None:
                    continue
                trainer = _trainer_on(init, _tiny(remat=remat), mesh)
                peaks.clear()
                runs[remat] = _fit_record(trainer, batches)
                runs[remat]["gathered_peak_bytes"] = max(peaks or [0])
                runs[remat]["gathers"] = len(peaks)
        finally:
            tp.LayerParallel.__init__ = original_init
            tp.LeafComm.gather = original_gather
        if runs:
            out[key] = runs[False]
            if record:
                out[key]["remat"] = runs[True]
    adapter = _trainer_on(init, _tiny(), make_mesh({"data": 2, "fsdp": 2},
                                                   "cpu"),
                          lora=lora, lora_rank=4, lora_alpha=8.0)
    out["lora"] = _fit_record(adapter, batches)
    out["lora"]["lora"] = _numpy(adapter.state.lora)
    return out


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return "no error"


def pipeline(rank, world, init, batches):
    """Trainer.fit with pipeline_stages=2 (2 microbatches, grad_accum 2,
    a 4-layer model) on {"pipe": 2} over ranks 0-1 and on {"data": 2,
    "pipe": 2} over all four; then the reference's refusals on real
    meshes."""
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.training import Trainer

    config = _tiny(n_layers=4)
    kw = dict(pipeline_stages=2, pipeline_microbatches=2, grad_accum=2)
    out = {}
    for key, shape, ranks in (("pipe=2", {"pipe": 2}, [0, 1]),
                              ("data=2,pipe=2", {"data": 2, "pipe": 2},
                               None)):
        mesh = make_mesh(shape, "cpu", ranks=ranks)
        if mesh.get_coordinate() is None:
            continue
        trainer = _trainer_on(init, config, mesh, **kw)
        out[key] = _fit_record(trainer, batches)
    refusals = {}
    for key, shape, extra, rules in (
            ("no pipe axis", {"fsdp": 4}, {}, None),
            ("lora", {"data": 2, "pipe": 2}, {"lora_rank": 4}, None),
            ("rules", {"data": 2, "pipe": 2}, {}, [(r".*", ())]),
            ("fsdp", {"fsdp": 2, "pipe": 2}, {}, None)):
        mesh = make_mesh(shape, "cpu")
        refusals[key] = _refusal(lambda: Trainer(
            config, _train_config(**dict(kw, **extra)), device="cpu",
            mesh=mesh, rules=rules))
    out["refusals"] = refusals
    return out


def _trainer_on(init, config, mesh, lora=None, **kw):
    from mlrun_tpu_torch.models.convert import params_from_numpy
    from mlrun_tpu_torch.training import Trainer

    trainer = Trainer(config, _train_config(**kw), device="cpu", mesh=mesh)
    trainer.init(params=params_from_numpy(init, "cpu"),
                 lora=None if lora is None else params_from_numpy(lora,
                                                                  "cpu"))
    return trainer


def elastic(rank, world, init, batches, ckpt_dir):
    """Four ranks in two slices on {"data": 2, "fsdp": 2}: slice 1 fails
    at the 5th poll and rejoins at the 8th of a 10-step fit that saves
    step 2; a fresh trainer on the survivors' mesh restored from that
    step; a reshard without a checkpoint; DCP restores 4 -> 2 and 2 ->
    4 ranks."""
    import json

    from mlrun_tpu_torch.chaos import chaos, fail_nth
    from mlrun_tpu_torch.obs import get_flight_recorder
    from mlrun_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from mlrun_tpu_torch.training import CheckpointManager, ElasticGuard

    config = _tiny()
    shape = {"data": 2, "fsdp": 2}
    guard = ElasticGuard(num_slices=2)
    trainer = _trainer(init, mesh_shape=shape)
    manager = CheckpointManager(os.path.join(ckpt_dir, "elastic"))

    def save_at_2(step, metrics, tr):
        if tr.state.step == 2:
            manager.save(2, tr.state, force=True)

    recorder = get_flight_recorder()
    recorder.clear()
    with chaos.inject("train.slice_fail", fail_nth(5),
                      action=lambda p, ctx: ctx["box"].__setitem__(
                          "fail", 1)), \
            chaos.inject("train.slice_fail", fail_nth(8),
                         action=lambda p, ctx: ctx["box"].__setitem__(
                             "join", 1)):
        last = trainer.fit(iter(batches), 10, log_every=1, prefetch=0,
                           callbacks=[save_at_2], checkpoint_manager=manager,
                           elastic_guard=guard)
    events = [e for e in recorder.events(kind="train.*")
              if e["kind"] not in ("train.fit_begin", "train.resume",
                                   "train.step")]
    with open(recorder.last_dump_path) as fp:
        dump_header = json.loads(fp.readline())
    out = {"history": [{k: h[k] for k in ("world_size", "step", "loss",
                                          "grad_norm")}
                       for h in trainer.metrics_history],
           "last": {k: last[k] for k in ("world_size", "step")},
           "events": events, "dump": dump_header,
           "goodput": trainer.goodput.summary(),
           "mesh": mesh_shape(trainer.mesh),
           "params": _numpy(trainer.state.params)}

    # a fresh run on the survivors' mesh, restored from the same step
    survivors = make_mesh({"data": 1, "fsdp": 2}, "cpu", ranks=[0, 1])
    if survivors.get_coordinate() is not None:
        fresh = _trainer_on(init, config, survivors)
        fresh.state = manager.restore(fresh.state, step=2)
        fresh.fit(iter(batches[4:7]), 3, log_every=1, prefetch=0)
        out["fresh"] = [h["loss"] for h in fresh.metrics_history]

    # a reshard without a checkpoint carries the live state
    carried = _trainer(init, mesh_shape=shape)
    carried.fit(iter(batches[:1]), 1, log_every=1, prefetch=0)
    before = _numpy(carried.state.params)
    info = carried.reshard([0, 1])
    out["carry"] = {"info": {k: info[k] for k in ("decision", "world_from",
                                                  "world_to")},
                    "before": before, "mesh": mesh_shape(carried.mesh)}
    if not carried.sitting_out:
        out["carry"]["after"] = _numpy(carried.state.params)

    # DCP across world sizes: 4 -> 2 and 2 -> 4
    for key, save_ranks, load_ranks in (("4to2", None, [0, 1]),
                                        ("2to4", [0, 1], None)):
        ck = CheckpointManager(os.path.join(ckpt_dir, key))
        saver_mesh = make_mesh({"fsdp": len(save_ranks or range(world))},
                               "cpu", ranks=save_ranks)
        loader_mesh = make_mesh({"fsdp": len(load_ranks or range(world))},
                                "cpu", ranks=load_ranks)
        row = {}
        if saver_mesh.get_coordinate() is not None:
            saver = _trainer_on(init, config, saver_mesh)
            saver.fit(iter(batches[:2]), 2, log_every=1, prefetch=0)
            ck.save(2, saver.state, force=True)
            row["saved"] = {"params": _numpy(saver.state.params),
                            "mu": _numpy(saver.state.opt_state.mu)}
        import torch.distributed as dist

        dist.barrier()
        if loader_mesh.get_coordinate() is not None:
            loader = _trainer_on(_perturbed(init), config, loader_mesh)
            restored = ck.restore(loader.state, step=2)
            row["restored"] = {"params": _numpy(restored.params),
                               "mu": _numpy(restored.opt_state.mu),
                               "step": restored.step,
                               "count": restored.opt_state.count,
                               "world": loader_mesh.size()}
        out[key] = row
    return out


def _perturbed(init):
    """``init`` with every leaf changed, so a restore must overwrite it."""
    if isinstance(init, dict):
        return {k: _perturbed(v) for k, v in init.items()}
    return init + 1.0


MOE_SHAPES = ({"expert": 2, "fsdp": 2}, {"expert": 4}, {"data": 2,
                                                        "fsdp": 2})


def expert_parallel(rank, world, init, batches):
    """Trainer.fit with moe_experts=4, moe_top_k=2 for len(batches) steps
    on each mesh of MOE_SHAPES (all four ranks); each rank's local shape
    of the expert leaves."""
    from mlrun_tpu_torch.models.moe import EXPERT_LEAVES
    from mlrun_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for shape in MOE_SHAPES:
        key = ",".join(f"{a}={n}" for a, n in shape.items())
        trainer = _trainer_on(init, _tiny(), make_mesh(shape, "cpu"),
                              moe_experts=4, moe_top_k=2)
        out[key] = _fit_record(trainer, batches)
        out[key]["expert_shapes"] = {
            name: tuple(trainer.state.params["layers"][name]
                        .to_local().shape) for name in EXPERT_LEAVES}
    from mlrun_tpu_torch.frameworks.torch import auto_trainer

    out["auto_trainer"] = auto_trainer.train(
        model="tiny", model_overrides={"remat": False}, batch_size=4,
        seq_len=32, steps=2, moe_experts=4, moe_top_k=2, log_every=1,
        mesh_shape={"expert": 2, "fsdp": 2}, device="cpu")
    return out


def _family_optimizer():
    from mlrun_tpu_torch.training.train import AdamW

    return AdamW(lambda count: 1e-2, b1=0.9, b2=0.999, weight_decay=1e-4)


def family_steps(rank, world, bert, vit, t5):
    """The families' sharded steps over all four ranks: BERT's classifier
    on {"data": 2, "tensor": 2} and ViT on {"fsdp": 4} for len(batches)
    steps from the reference's init (plain trees, placed by the step);
    T5 on {"fsdp": 2, "tensor": 2}, each step from the reference's state
    before it (params and AdamW moments)."""
    import torch

    from mlrun_tpu_torch.models import bert as tbert
    from mlrun_tpu_torch.models import t5 as tt5
    from mlrun_tpu_torch.models import vit as tvit
    from mlrun_tpu_torch.models.convert import params_from_numpy
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.parallel.sharding import shard_pytree
    from mlrun_tpu_torch.training.train import AdamWState

    def run(step, params, opt_state, batches):
        history = []
        for batch in batches:
            params, opt_state, metrics = step(
                params, opt_state, *(torch.from_numpy(a) for a in batch))
            history.append({k: float(v) for k, v in metrics.items()})
        return params, history

    out = {}
    for name, family, make, shape, data in (
            ("bert", tbert.tiny_bert, tbert.make_classifier_train_step,
             {"data": 2, "tensor": 2}, bert),
            ("vit", tvit.tiny_vit, tvit.make_train_step, {"fsdp": 4}, vit)):
        mesh = make_mesh(shape, "cpu")
        optimizer = _family_optimizer()
        params = params_from_numpy(data["init"], "cpu")
        step = make(family(dtype=torch.float32, attention_impl="auto"),
                    optimizer, mesh)
        params, history = run(step, params, optimizer.init(params),
                              data["batches"])
        out[name] = {"history": history, "params": _numpy(params),
                     "shards": _shards(params),
                     "coordinate": mesh.get_coordinate()}
    mesh = make_mesh({"fsdp": 2, "tensor": 2}, "cpu")
    step = tt5.make_train_step(tt5.tiny_t5(dtype=torch.float32),
                               _family_optimizer(), mesh=mesh)
    steps = []
    for (params, mu, nu, count), batch in zip(t5["states"], t5["batches"]):
        state = AdamWState(count, params_from_numpy(mu, "cpu"),
                           params_from_numpy(nu, "cpu"))
        grads, _ = step.compute_grads(
            shard_pytree(params_from_numpy(params, "cpu"), mesh),
            *(torch.from_numpy(a) for a in batch))
        params, history = run(step, params_from_numpy(params, "cpu"), state,
                              [batch])
        steps.append({"metrics": history[0], "params": _numpy(params),
                      "grads": [g.full_tensor().numpy() for g in grads]})
    out["t5"] = steps
    return out


LORA_SHAPES = ({"tensor": 2}, {"fsdp": 2, "tensor": 2})


def lora_tensor(rank, world, init, lora, batches, hf_dir):
    """A rank-4 LoRA adapter trained on each of LORA_SHAPES (the first
    ranks of the group that it needs), then the HF checkpoint ``hf_dir``
    loaded with ``shardings=`` onto {"fsdp": 2} over ranks 0-1 against a
    load on the device."""
    import math

    import torch

    from mlrun_tpu_torch.frameworks.huggingface import (
        load_hf_weights_into_llama,
    )
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.parallel.sharding import tree_shardings
    from mlrun_tpu_torch.training.train import tree_leaves

    out = {}
    for shape in LORA_SHAPES:
        key = ",".join(f"{a}={n}" for a, n in shape.items())
        mesh = make_mesh(shape, "cpu",
                         ranks=range(math.prod(shape.values())))
        if mesh.get_coordinate() is None:
            continue
        trainer = _trainer_on(init, _tiny(), mesh, lora=lora, lora_rank=4,
                              lora_alpha=8.0)
        out[key] = _fit_record(trainer, batches)
        out[key]["lora"] = _numpy(trainer.state.lora)
    mesh = make_mesh({"fsdp": 2}, "cpu", ranks=[0, 1])
    if mesh.get_coordinate() is not None:
        _, plain = load_hf_weights_into_llama(hf_dir, device="cpu")
        _, placed = load_hf_weights_into_llama(
            hf_dir, device="cpu", shardings=tree_shardings(plain, mesh))
        leaves = tree_leaves(placed)
        out["hf"] = {
            "bit_equal": [torch.equal(p.full_tensor(), q) for p, q in
                          zip(leaves, tree_leaves(plain))],
            "local_numel": sum(p.to_local().numel() for p in leaves),
            "numel": sum(q.numel() for q in tree_leaves(plain))}
    return out


class _RecordingContext:
    """A duck-typed run context with no ``is_logging_worker``: the port's
    callbacks and fit fall back to ``execution.is_logging_worker``."""

    def __init__(self):
        self.metrics, self.artifacts, self.results = [], [], {}

    def log_metrics(self, metrics, step=None):
        self.metrics.append(sorted(metrics))

    def log_result(self, key, value):
        self.results[key] = value

    def log_results(self, results):
        self.results.update(results)

    def log_artifact(self, key, **kw):
        self.artifacts.append(key)


def logging_worker(rank, world, init, batches, y_true, y_pred):
    """A 2-rank {"data": 2} fit with MetricsLoggingCallback and an
    EvalPlanCallback over a recording context: what each rank logged."""
    from mlrun_tpu_torch.execution import is_logging_worker
    from mlrun_tpu_torch.frameworks._common import (
        ConfusionMatrixPlan,
        EvalPlanCallback,
        MetricsLoggingCallback,
    )

    trainer = _trainer(init, mesh_shape={"data": world})
    context = _RecordingContext()
    callbacks = [MetricsLoggingCallback(),
                 EvalPlanCallback(lambda model: (y_true, y_pred),
                                  plans=[ConfusionMatrixPlan()])]
    trainer.fit(iter(batches), len(batches), context=context, log_every=2,
                prefetch=0, callbacks=callbacks, epoch_steps=2)
    return {"worker": is_logging_worker(), "metrics": context.metrics,
            "artifacts": context.artifacts}
