"""Checkpoint/resume — counterpart of ``mlrun_tpu/training/checkpoint.py``
(which saves sharded states with orbax).

One ``<directory>/<step>/`` per step, the oldest pruned past
``max_to_keep``, in one of two forms:

- a single-device state: ``torch.save`` of ``params.pt`` (the params) and
  ``state.pt`` (the rest), written to a temporary name and renamed into
  place;
- a sharded state (DTensor leaves on a mesh): one
  ``torch.distributed.checkpoint`` (DCP) save over the mesh's ranks,
  each writing its shards, the mesh's lowest rank renaming the directory
  once the metadata is down. DCP reads a checkpoint back onto any mesh,
  so a state saved at one world size restores at another (an elastic
  reshard).

``restore`` reads either form into the form of the state it is given;
``restore_params`` reads the params alone of either form onto one device
(no process group needed), so evaluation never holds the optimizer state.
Saves are synchronous, so ``wait`` and ``close`` have nothing to wait
for. ``resume_directive`` reads the environment contract under which a
resubmitted job resumes.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist

# the checkpoint-resume environment contract of a resubmitted run
from ..common.runtimes_constants import RESUME_CHECKPOINT_ENV, RESUME_STEP_ENV

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"
DCP_METADATA = ".metadata"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 0):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps or 1

    def _steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and _is_checkpoint(
                          os.path.join(self.directory, name)))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` as checkpoint ``step``; a step already on disk
        counts as saved. Without ``force``, only every
        ``save_interval_steps``-th step is written. A sharded state is a
        collective: every rank calls ``save``."""
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        final = os.path.join(self.directory, str(step))
        if _is_checkpoint(final):
            return True
        tree = _to_tree(state)
        sharded = _is_sharded(tree)
        # the temporary name must be the same on every rank of a DCP save
        tmp = os.path.join(self.directory, f".{step}.tmp" if sharded
                           else f".{step}.tmp-{os.getpid()}")
        if sharded:
            import torch.distributed.checkpoint as dcp

            group, members = _mesh_group(tree)
            tree["opt_state"]["count"] = torch.tensor(
                tree["opt_state"]["count"])
            tree["step"] = torch.tensor(tree["step"])
            # a mesh of one rank inside a larger group saves alone
            dcp.save(tree, checkpoint_id=tmp, process_group=group,
                     no_dist=len(members) == 1 < dist.get_world_size())
            lead = dist.get_rank() == min(members)
        else:
            os.makedirs(tmp, exist_ok=True)
            if isinstance(tree, dict) and "params" in tree:
                tree = dict(tree)
                torch.save(tree.pop("params"), os.path.join(tmp, PARAMS_FILE))
            torch.save(tree, os.path.join(tmp, STATE_FILE))
            lead = True
        if lead:
            os.replace(tmp, final)
            if self.max_to_keep:
                for old in self._steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)),
                                  ignore_errors=True)
        if sharded and len(members) > 1:
            dist.barrier(group=group)   # every rank sees the renamed step
        return True

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore ``step`` (default: latest) in the form of
        ``state_like``: tensors land on the device of ``state_like``'s
        params; a sharded ``state_like`` reads a DCP checkpoint back into
        its own placements (fresh DTensors: a failed read leaves the live
        state whole), and leaves that required grad require it again."""
        path = self._step_dir(step)
        if os.path.isfile(os.path.join(path, DCP_METADATA)):
            import torch.distributed.checkpoint as dcp

            tree = _to_tree(state_like)
            tree["opt_state"]["count"] = torch.tensor(0)
            tree["step"] = torch.tensor(0)
            skeleton = _map_tensors(torch.empty_like, tree)
            group, members = _mesh_group(tree) if _is_sharded(tree) \
                else (None, [])
            dcp.load(skeleton, checkpoint_id=path, process_group=group,
                     no_dist=not dist.is_initialized()
                     or len(members) == 1 < dist.get_world_size())
            return _from_tree(state_like, skeleton)
        if _is_sharded(_to_tree(state_like)):
            raise ValueError(
                f"{path} holds a single-device checkpoint; a sharded state "
                "restores from a sharded (DCP) checkpoint only")
        location = _device_of(state_like)
        tree = torch.load(os.path.join(path, STATE_FILE),
                          map_location=location, weights_only=False)
        if os.path.isfile(os.path.join(path, PARAMS_FILE)):
            tree["params"] = self.restore_params(step, location)
        return _from_tree(state_like, tree)

    def restore_params(self, step: int | None = None, device="cpu"):
        """The params of ``step`` (default: latest) alone, as full plain
        tensors on ``device``, from either form (a DCP checkpoint reads
        only the params' entries, without a process group)."""
        path = self._step_dir(step)
        if not os.path.isfile(os.path.join(path, DCP_METADATA)):
            return torch.load(os.path.join(path, PARAMS_FILE),
                              map_location=device, weights_only=False)
        import torch.distributed.checkpoint as dcp

        metadata = dcp.FileSystemReader(path).read_metadata()
        params: dict = {}
        for key, entry in metadata.state_dict_metadata.items():
            names = key.split(".")
            if names[0] != "params":
                continue
            node = params
            for name in names[1:-1]:
                node = node.setdefault(name, {})
            node[names[-1]] = torch.empty(entry.size,
                                          dtype=entry.properties.dtype,
                                          device=device)
        tree = {"params": params}
        dcp.load(tree, checkpoint_id=path, no_dist=True)
        return tree["params"]

    def _step_dir(self, step: int | None) -> str:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(int(step)))
        if not _is_checkpoint(path):
            raise FileNotFoundError(f"no checkpoint {step} in "
                                    f"{self.directory}")
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open."""


def save_checkpoint_artifact(context, key: str, manager: CheckpointManager,
                             framework: str = "torch", **kwargs):
    """Register the checkpoint dir as a model artifact on the run."""
    manager.wait()
    record = getattr(context, "log_checkpoint", None)
    if record is not None:
        # status.checkpoint is what the service monitor wires into a
        # resubmitted JobSet's resume env (runtime_handlers.TpuJobHandler)
        record(manager.directory, step=manager.latest_step(), commit=False)
    return context.log_model(
        key, model_dir=manager.directory, framework=framework,
        upload=False, target_path=manager.directory, **kwargs)


def resume_directive() -> tuple[str, Optional[int]] | None:
    """The checkpoint-resume contract a resubmitted run finds in its
    environment: (path, step), or None. The step is None when only the
    path was recorded (or the step does not parse)."""
    path = os.environ.get(RESUME_CHECKPOINT_ENV, "")
    if not path:
        return None
    step_raw = os.environ.get(RESUME_STEP_ENV, "")
    try:
        step = int(step_raw) if step_raw else None
    except ValueError:
        step = None
    return path, step


def _is_checkpoint(path: str) -> bool:
    return any(os.path.isfile(os.path.join(path, name))
               for name in (STATE_FILE, DCP_METADATA))


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _is_sharded(tree) -> bool:
    from .train import tree_leaves

    return isinstance(tree, dict) and "params" in tree and any(
        _is_dtensor(leaf) for leaf in tree_leaves(tree["params"]))


def _mesh_group(tree) -> tuple:
    """(process group, its ranks) of the mesh a sharded tree lives on."""
    from ..parallel.mesh import axes_group
    from .train import tree_leaves

    mesh = next(leaf for leaf in tree_leaves(tree["params"])
                if _is_dtensor(leaf)).device_mesh
    return axes_group(mesh, range(mesh.ndim))


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {key: _map_tensors(fn, value) for key, value in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _device_of(state_like):
    from .train import TrainState, tree_leaves

    if isinstance(state_like, TrainState):
        return tree_leaves(state_like.params)[0].device
    return "cpu"


def _to_tree(state):
    from .train import TrainState, tree_map

    if isinstance(state, TrainState):
        detach = lambda t: t.detach()  # noqa: E731
        opt = state.opt_state
        tree = {"params": tree_map(detach, state.params),
                "opt_state": {"count": opt.count, "mu": opt.mu,
                              "nu": opt.nu},
                "step": state.step}
        if state.lora is not None:
            tree["lora"] = tree_map(detach, state.lora)
        return tree
    return state


def _from_tree(state_like, tree):
    from .train import AdamWState, TrainState, tree_leaves

    if not isinstance(state_like, TrainState):
        return tree
    params, lora = tree["params"], tree.get("lora")
    # the trained tree requires grad (a LoRA run's base stays frozen);
    # DTensor leaves never do: the step differentiates gathered copies
    for leaf in tree_leaves(params):
        if not _is_dtensor(leaf):
            leaf.requires_grad_(lora is None)
    for leaf in tree_leaves(lora or {}):
        if not _is_dtensor(leaf):
            leaf.requires_grad_(True)
    opt = tree["opt_state"]
    return TrainState(params, AdamWState(int(opt["count"]), opt["mu"],
                                         opt["nu"]), int(tree["step"]),
                      lora)
