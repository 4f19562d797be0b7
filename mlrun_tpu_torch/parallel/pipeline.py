"""Pipeline parallelism — GPipe stages over a ``pipe`` mesh axis;
counterpart of ``mlrun_tpu/parallel/pipeline.py``.

The stacked layer tree ``[L, ...]`` is split into P stages of ``[L/P,
...]`` (:func:`split_layers_for_stages`); pipe rank p holds stage p's
layers only. A step runs the reference's fill/drain schedule with M
microbatches, its activations handed between pipe neighbours point to
point instead of rotated by ``ppermute``: each rank runs its stage's
forward on every microbatch in order (stage 0 embeds the tokens, every
other stage receives its input from the stage before, and every stage
but the last sends its output on), then the backward in reverse order
(the last stage starts from the loss; every other stage receives the
gradient of its output from the stage after, and every stage but the
first sends the gradient of its input back). The last stage applies the
final norm and the head and sums the microbatches' nll; the loss is the
mean over the whole batch, as the reference's ``pipeline_loss_fn``.

A stage's work is a plain function of its layers and its input
activations (:func:`stage_forward`, models/llama.py ``run_layers``), and
the hand-offs go through a link: :class:`RankLink` over
``torch.distributed`` between the pipe ranks, or :class:`LocalLink` in
one process, where the stages run in turn in the GPipe order
(:func:`run_in_process`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.llama import LlamaConfig, chunked_sums, lm_head, run_layers
from ..ops.norms import rms_norm
from ..ops.rotary import rope_table

# pipelined params: the stage-split layer tree [P, L/P, ...] shards its
# stage dim over 'pipe'; everything else (embedding, final norm, head)
# is replicated
PP_RULES: list[tuple[str, tuple]] = [
    (r".*layers.*", ("pipe",)),
    (r".*", ()),
]


def split_layers_for_stages(layers: dict, n_stages: int) -> dict:
    """[L, ...] stacked layer tree -> [P, L/P, ...]."""

    def reshape(leaf):
        if leaf.shape[0] % n_stages:
            raise ValueError(
                f"n_layers {leaf.shape[0]} not divisible by "
                f"{n_stages} stages")
        return leaf.reshape(n_stages, leaf.shape[0] // n_stages,
                            *leaf.shape[1:])

    return {name: reshape(leaf) for name, leaf in layers.items()}


def stage_forward(config: LlamaConfig, stage_layers: dict, x: torch.Tensor,
                  cos, sin) -> torch.Tensor:
    """One stage's L/P layers over its input activations ``x`` [mb, S, E]
    (the reference's ``stage_fn``), with the model's per-layer remat."""
    return run_layers(config, stage_layers, x, cos, sin)


class Stage:
    """Stage ``index`` of ``n_stages`` over one batch split into
    ``microbatches``: ``forward(m)`` and ``backward(m)`` run microbatch m
    through the stage, handing activations and their gradients on
    through ``link``. ``params`` is the rank's plain tree: ``layers``
    holds the stage's ``[L/P, ...]`` leaves, beside the embedding, the
    final norm and the head; leaves that require grad accumulate their
    ``.grad`` over the microbatches."""

    def __init__(self, config: LlamaConfig, params: dict, tokens, targets,
                 index: int, n_stages: int, microbatches: int, link,
                 loss_chunk: int = 0):
        b, s = tokens.shape
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible by {microbatches} "
                             "microbatches")
        self.config, self.params = config, params
        self.tokens, self.targets = tokens, targets
        self.index, self.n_stages = index, n_stages
        self.first, self.last = index == 0, index == n_stages - 1
        self.mb, self.link = b // microbatches, link
        self.chunk = loss_chunk or s
        self.act_shape = (self.mb, s, config.embed_dim)
        self.cos, self.sin = rope_table(
            torch.arange(s, device=tokens.device), config.head_dim,
            config.rope_theta)
        self.inputs, self.outputs, self.stats = {}, {}, {}

    def _rows(self, x, m):
        return x[m * self.mb:(m + 1) * self.mb]

    def forward(self, m: int):
        config = self.config
        if self.first:
            x = self.params["embedding"][self._rows(self.tokens, m)].to(
                config.dtype)
        else:
            x = self.link.recv(self.act_shape, config.dtype,
                               self.tokens.device, self.index - 1, self.index,
                               ("act", m)).requires_grad_(True)
        y = stage_forward(config, self.params["layers"], x, self.cos,
                          self.sin)
        if self.last:
            h = rms_norm(y, self.params["final_norm_scale"], config.norm_eps)
            self.stats[m] = chunked_sums(h, lm_head(self.params),
                                         self._rows(self.targets, m),
                                         chunk=self.chunk)
        else:
            self.link.send(y.detach(), self.index, self.index + 1, ("act", m))
        self.inputs[m], self.outputs[m] = x, y

    def sums(self) -> torch.Tensor:
        """[nll sum, correct count, token count] of the microbatches this
        stage finished (zeros on every stage but the last)."""
        if not self.last:
            return torch.zeros(3, dtype=torch.float32,
                               device=self.tokens.device)
        return torch.stack([sum(s[i].detach() for s in self.stats.values())
                            for i in range(3)])

    def backward(self, m: int):
        if self.last:
            count = torch.clamp_min(self.sums()[2], 1.0)
            torch.autograd.backward(self.stats[m][0] / count)
        else:
            grad = self.link.recv(self.act_shape, self.config.dtype,
                                  self.tokens.device, self.index + 1,
                                  self.index, ("grad", m))
            torch.autograd.backward(self.outputs[m], grad)
        if not self.first:
            self.link.send(self.inputs[m].grad, self.index, self.index - 1,
                           ("grad", m))
        del self.inputs[m], self.outputs[m]


def run_rank(stage: Stage, microbatches: int):
    """One rank's GPipe schedule: every forward, then every backward in
    reverse microbatch order."""
    for m in range(microbatches):
        stage.forward(m)
    for m in reversed(range(microbatches)):
        stage.backward(m)


def run_in_process(stages: list, microbatches: int):
    """Every stage in one process, in the GPipe fill/drain order: at clock
    t stage p runs microbatch t - p forward, then the backward drains
    the other way (a :class:`LocalLink` carries the hand-offs)."""
    n = len(stages)
    for t in range(microbatches + n - 1):
        for p, stage in enumerate(stages):
            if 0 <= t - p < microbatches:
                stage.forward(t - p)
    for t in range(microbatches + n - 1):
        for p in reversed(range(n)):
            m = microbatches - 1 - (t - (n - 1 - p))
            if 0 <= m < microbatches:
                stages[p].backward(m)


class RankLink:
    """Hand-offs between pipe neighbours over ``torch.distributed``:
    ``ranks[p]`` is the global rank holding stage p on this rank's pipe
    line (blocking send / recv; each pair of neighbours exchanges in
    one order, so no tag is needed)."""

    def __init__(self, ranks: list):
        self.ranks = list(ranks)

    def send(self, tensor, src: int, dst: int, what):
        dist.send(tensor.contiguous(), self.ranks[dst])

    def recv(self, shape, dtype, device, src: int, dst: int, what):
        out = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(out, self.ranks[src])
        return out


class LocalLink:
    """Hand-offs between stages that run in one process: a send leaves a
    copy where the matching recv picks it up."""

    def __init__(self):
        self.box = {}
        self.handoffs = 0

    def send(self, tensor, src: int, dst: int, what):
        self.box[(src, dst, what)] = tensor.detach().clone()
        self.handoffs += 1

    def recv(self, shape, dtype, device, src: int, dst: int, what):
        out = self.box.pop((src, dst, what))
        assert tuple(out.shape) == tuple(shape) and out.dtype == dtype
        return out
