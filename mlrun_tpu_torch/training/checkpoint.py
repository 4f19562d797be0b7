"""Single-device checkpoint/resume — counterpart of
``mlrun_tpu/training/checkpoint.py`` (which saves sharded states with
orbax). The port saves the train state of one device with ``torch.save``:
one ``<directory>/<step>/`` per step holding ``params.pt`` (the params)
and ``state.pt`` (the rest), written to a temporary name and renamed into
place, the oldest pruned past ``max_to_keep``. ``restore_params`` reads
the params alone, so evaluation never holds the optimizer state on the
host. Saves are synchronous, so ``wait`` and ``close`` have nothing to
wait for.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 0):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps or 1

    def _steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` as checkpoint ``step``; a step already on disk
        counts as saved. Without ``force``, only every
        ``save_interval_steps``-th step is written."""
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        final = os.path.join(self.directory, str(step))
        if os.path.isfile(os.path.join(final, STATE_FILE)):
            return True
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        tree = _to_tree(state)
        if isinstance(tree, dict) and "params" in tree:
            tree = dict(tree)
            torch.save(tree.pop("params"), os.path.join(tmp, PARAMS_FILE))
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        return True

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore ``step`` (default: latest) in the form of
        ``state_like``: tensors land on the device of ``state_like``'s
        params, leaves that required grad require it again."""
        path = self._step_dir(step)
        location = _device_of(state_like)
        tree = torch.load(os.path.join(path, STATE_FILE),
                          map_location=location, weights_only=False)
        if os.path.isfile(os.path.join(path, PARAMS_FILE)):
            tree["params"] = self.restore_params(step, location)
        return _from_tree(state_like, tree)

    def restore_params(self, step: int | None = None, device="cpu"):
        """The params of ``step`` (default: latest) alone, each leaf read
        and moved to ``device`` in turn."""
        return torch.load(os.path.join(self._step_dir(step), PARAMS_FILE),
                          map_location=device, weights_only=False)

    def _step_dir(self, step: int | None) -> str:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self.directory, str(int(step)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open."""


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
    # the trained tree requires grad; a LoRA run's base stays frozen
    for leaf in tree_leaves(params):
        leaf.requires_grad_(lora is None)
    for leaf in tree_leaves(lora or {}):
        leaf.requires_grad_(True)
    opt = tree["opt_state"]
    return TrainState(params, AdamWState(int(opt["count"]), opt["mu"],
                                         opt["nu"]), int(tree["step"]),
                      lora)
