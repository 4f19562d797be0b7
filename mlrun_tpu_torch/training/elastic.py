"""Elastic multi-slice training: the slice-aware fault model — counterpart
of ``mlrun_tpu/training/elastic.py``.

:class:`ElasticGuard` partitions the process group's ranks (one per GPU)
into ``num_slices`` contiguous slices and tracks which are alive.
``Trainer.fit(elastic_guard=)`` polls it once per step and reacts to
its events:

- ``fail``: a slice died. Every rank reshards (``Trainer.reshard``) onto
  a mesh over the survivors' ranks, refit by rescaling one axis, and the
  survivors restore the train state from the latest checkpoint (DCP
  reads it across world sizes). The failed slice's ranks sit out the
  degraded steps: they enter none of the survivors' collectives and only
  keep their data stream in step.
- ``join``: the slice is back. Every rank reshards onto the full mesh and
  the survivors hand the live state over (``carry_live_state``): no step
  is rewound.

Detection, in order: programmatic ``fail_slice`` / ``join_slice``, and
the ``train.slice_fail`` chaos point, fired with a mutable ``box`` on
every poll; an armed injection setting ``box["fail"]`` / ``box["join"]``
fails or revives a slice in that step. The injection is the failure: no
rank dies, and because the schedule is deterministic every rank sees the
same event in the same step, which is what lets the failed ranks agree
to sit out and the survivors' new groups form.

A real death needs more than this, and is out of scope here: the dead
ranks cannot take part in creating the survivors' process groups (every
rank of the default group must), so the survivors would need a fresh
group (a new rendezvous, or a launcher restarting them with a new
world), and an external signal in place of the chaos point would have to
reach every survivor in the same step. The checkpoint restore already
reads nothing from the dead slice's ranks.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Optional

from ..chaos import chaos
from ..chaos import fire as chaos_fire
from ..utils import logger

NUM_SLICES_ENV = "MLT_NUM_SLICES"


@dataclasses.dataclass(frozen=True)
class SliceEvent:
    """One slice-membership change observed by a poll."""

    kind: str           # "fail" | "join"
    slice_index: int
    ranks: tuple        # the ACTIVE ranks after this event


class ElasticGuard:
    """Tracks slice liveness over the process group's ranks (default
    every rank; ``num_slices`` default ``MLT_NUM_SLICES`` or 1). Single
    consumer: the training loop; the event queue is a ``deque``."""

    def __init__(self, ranks=None, num_slices: int | None = None):
        if ranks is None:
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            ranks = range(world)
        ranks = [int(r) for r in ranks]
        if not ranks:
            raise ValueError("elastic guard needs at least one rank")
        num_slices = int(num_slices or os.environ.get(NUM_SLICES_ENV) or 1)
        if num_slices < 1 or len(ranks) % num_slices:
            raise ValueError(
                f"{len(ranks)} ranks do not split into {num_slices} equal "
                "slices")
        per = len(ranks) // num_slices
        self._slices = [ranks[i * per:(i + 1) * per]
                        for i in range(num_slices)]
        self._failed: set[int] = set()
        self._events: deque = deque()

    @property
    def num_slices(self) -> int:
        return len(self._slices)

    @property
    def failed_slices(self) -> list[int]:
        return sorted(self._failed)

    @property
    def degraded(self) -> bool:
        return bool(self._failed)

    @property
    def ranks(self) -> list:
        """The ACTIVE ranks (every rank of every live slice)."""
        return [r for i, group in enumerate(self._slices)
                if i not in self._failed for r in group]

    def lost_fraction(self) -> float:
        """Capacity fraction lost to failed slices — the ``degraded``
        goodput bucket's tax rate."""
        return len(self._failed) / len(self._slices)

    def fail_slice(self, slice_index: int):
        """Mark a slice preempted. Failing the last live slice is a job
        failure, not elasticity, and raises."""
        slice_index = self._validate(slice_index)
        if slice_index in self._failed:
            return
        if len(self._failed) + 1 >= len(self._slices):
            raise ValueError(
                f"slice {slice_index} is the last survivor — no elastic "
                "recovery exists for losing every slice")
        self._failed.add(slice_index)
        logger.warning("slice preempted", slice=slice_index,
                       survivors=len(self.ranks))
        self._events.append(SliceEvent("fail", slice_index,
                                       tuple(self.ranks)))

    def join_slice(self, slice_index: int):
        """A replacement for a failed slice joined (grow-back)."""
        slice_index = self._validate(slice_index)
        if slice_index not in self._failed:
            return
        self._failed.discard(slice_index)
        logger.info("slice rejoined", slice=slice_index,
                    world=len(self.ranks))
        self._events.append(SliceEvent("join", slice_index,
                                       tuple(self.ranks)))

    def _validate(self, slice_index: int) -> int:
        slice_index = int(slice_index)
        if not 0 <= slice_index < len(self._slices):
            raise ValueError(
                f"slice {slice_index} out of range "
                f"(num_slices={len(self._slices)})")
        return slice_index

    def poll(self) -> Optional[SliceEvent]:
        """One health check, called once per train step: fires the
        ``train.slice_fail`` chaos point (one attribute read when nothing
        is armed) and returns the oldest pending change, or None."""
        if chaos.enabled:
            box: dict = {"fail": None, "join": None}
            chaos_fire("train.slice_fail", box=box,
                       failed=self.failed_slices,
                       num_slices=len(self._slices))
            if box["fail"] is not None:
                self.fail_slice(box["fail"])
            if box["join"] is not None:
                self.join_slice(box["join"])
        return self._events.popleft() if self._events else None
