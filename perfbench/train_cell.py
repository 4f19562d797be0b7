"""A training cell: the port's ``Trainer.fit`` (the call a ``tpujob``
run's ``auto_trainer.train`` makes) on packed documents at the
configuration's widths.

Set-up builds one trainer from the seed's weights, loads its kernels,
then drives it through the checked steps with ``fit`` on the same feed
the window uses, recording each step's loss, the first gradient by leaf
as AdamW got it (its first moment after one step over 1 - b1) and each
leaf's change after the checked steps. The window is one more ``fit``
call on that trainer and feed, stopped by a callback once the window's
seconds have passed; it ends with a synchronise. The plain reference
then follows the checked steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import time

import checks
import models
import traffic as traffic_mod


def leaf_items(tree: dict, prefix: str = ""):
    """(dotted path, leaf) in sorted-key order."""
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            yield from leaf_items(tree[key], path + ".")
        else:
            yield path, tree[key]


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {path: float(leaf.detach().float().norm()) * scale
            for path, leaf in leaf_items(tree)}


def _samples(tree: dict, scale: float = 1.0) -> dict:
    """A fixed strided sample of every leaf (``checks.sample``), scaled,
    on the host."""
    return {path: (checks.sample(leaf.detach()) * scale).cpu()
            for path, leaf in leaf_items(tree)}


def train_config(mix: dict, sizes: dict):
    from mlrun_tpu_torch.training.train import TrainConfig

    opt = mix["optimizer"]
    return TrainConfig(
        learning_rate=opt["learning_rate"], warmup_steps=opt["warmup_steps"],
        total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
        grad_clip=opt["grad_clip"], b1=opt["b1"], b2=opt["b2"],
        loss_chunk=mix["loss_chunk"], moe_experts=sizes.get("n_experts", 0),
        moe_top_k=sizes.get("top_k", 2),
        moe_capacity_factor=sizes.get("capacity_factor", 1.25))


class Feed:
    """The plan's rows as host tensors, the first ``keep`` of them kept
    for the reference."""

    def __init__(self, plan, keep: int):
        self.plan, self.keep, self.kept = plan, keep, []

    def __iter__(self):
        import torch

        while True:
            tokens, targets = self.plan.rows()
            if len(self.kept) < self.keep:
                self.kept.append((tokens.copy(), targets.copy()))
            yield torch.from_numpy(tokens), torch.from_numpy(targets)


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float, config_overrides=None, check_limit=True,
        fault=None, control=None) -> dict:
    import torch

    from devtrace import DeviceTrace
    from mlrun_tpu_torch.frameworks._common.callbacks import Callback
    from mlrun_tpu_torch.training.data import DevicePrefetchIterator
    from mlrun_tpu_torch.training.train import Trainer

    mix, conf = cell.traffic, cell.config
    marks = [("start", started), ("imported", time.perf_counter())]
    sizes = models.sizes(conf)
    if config_overrides:
        sizes.update(config_overrides)
    model = models.port_config(conf, **(config_overrides or {}))
    tconf = train_config(mix, sizes)
    b1 = tconf.b1
    steps = int(mix["check_steps"])
    trainer = Trainer(model, tconf, device=device)
    trainer.init(params=models.make_params(sizes, seed, device))
    marks.append(("weights", time.perf_counter()))
    if fault is not None:
        fault(trainer)
    plan = traffic_mod.plan(mix, seed, sizes["vocab_size"])
    feed = Feed(plan, steps)
    stream = DevicePrefetchIterator(iter(feed), device=device)
    trainer.warmup(plan.batch, plan.seq)
    marks.append(("trainer_warmup", time.perf_counter()))
    cuda = torch.device(device).type == "cuda"

    class Record(Callback):
        """Each checked step's loss; after the first, the first moment
        of every leaf."""

        def __init__(self):
            self.losses, self.grad_norms, self.grad_samples = [], None, None

        def on_step_end(self, step, metrics):
            value = metrics["loss"]
            self.losses.append(value.detach().float().clone()
                               if torch.is_tensor(value) else value)
            if step == 0:
                mu = trainer.state.opt_state.mu
                self.grad_norms = _norms(mu, 1.0 / (1.0 - b1))
                self.grad_samples = _samples(mu, 1.0 / (1.0 - b1))

    record = Record()
    trainer.fit(stream, steps, callbacks=[record], log_every=steps)
    marks.append(("checked_steps", time.perf_counter()))
    prog = {"losses": [float(x) for x in record.losses],
            "grad_norms": record.grad_norms,
            "grad_samples": record.grad_samples,
            "change_norms": _change_norms(trainer.state.params, sizes, seed,
                                          device)}
    profiler = DeviceTrace() if trace else None
    if profiler is not None:
        profiler.prime()

    class Stop(Callback):
        """Ends ``fit`` at the first step end past the window's close;
        in the traced run, profiles a stretch of the window's middle."""

        def __init__(self, t0: float):
            self.t0, self.steps = t0, 0

        def on_step_end(self, step, metrics):
            self.steps += 1
            now = time.perf_counter()
            if profiler is not None:
                if profiler.t_start is None and \
                        now >= self.t0 + 0.4 * seconds:
                    profiler.start()
                elif profiler.active and now >= profiler.t_start + \
                        cell.trace_seconds:
                    profiler.stop()
            if now >= self.t0 + seconds:
                if profiler is not None and profiler.active:
                    profiler.stop()
                return False
            return None

    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - started
    marks.append(("window", t0))
    stop = Stop(t0)
    last = trainer.fit(stream, 1 << 30, callbacks=[stop], log_every=1 << 30)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    stream.close()
    failed = 0 if all(_finite(v) for v in last.values()
                      if isinstance(v, float)) else stop.steps
    steps_in_window = stop.steps
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    summary = profiler.summary() if profiler is not None else None
    trainer.state = None
    del trainer, stream, record, stop, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from serve_cell import _note_memory

    _note_memory(device, "after the window")
    reference = checks.reference_module(conf)
    ref = reference.train_reference(sizes, seed, device, feed.kept,
                                    mix["optimizer"])
    check = checks.train_check(cell, prog, ref, check_limit)
    if control:
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        low = reference.train_reference(sizes, seed, device, feed.kept,
                                        mix["optimizer"], quant=control)
        check["control"] = checks.train_check(cell, low, ref, False)
    return {
        "kind": "train", "seed": seed, "setup_s": setup_s, "t0": t0,
        "t1": t1, "window_s": t1 - t0, "steps_in_window": steps_in_window,
        "failed_steps": failed, "batch": plan.batch, "seq": plan.seq,
        "tokens_in_window": steps_in_window * plan.batch * plan.seq,
        "trace": summary, "sizes": sizes, "memory_peak_bytes": peak,
        "setup_marks": marks,
        "check": check, "program": prog, "reference": ref,
    }


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def _change_norms(params: dict, sizes: dict, seed: int, device) -> dict:
    """Each leaf's change from its initial bits (drawn again from the
    seed, one leaf at a time), as a float32 norm."""
    current = dict(leaf_items(params))
    out = {}
    for path, start in models.draw_leaves(sizes, seed, device):
        key = ".".join(path)
        out[key] = float((current[key].detach().float()
                          - start.float()).norm())
        del start
    return out
