"""Where the time goes in one training step of the port (mlrun_tpu_torch)
on one GPU: Llama-3.2-1B at full width and depth through the Trainer's
step, traced with torch.profiler.

    python3 scripts/profile_torch_training.py [--seed 0] [--out DIR]

The step is the chip smoke test's: random bf16 weights from a seed, batch
4 x 2048 synthetic tokens, loss chunks of 512, per-layer remat (policy
``nothing``), AdamW with moments in bf16.

It prints one JSON line: wall ms per step (host clock around synchronised
steps), device busy ms (sum of CUDA kernel times in the trace), the idle
share (1 - busy / wall), device ms by group (the flash forward kernel, the
two flash backward kernels, matrix products, everything else), the
optimizer update alone (CUDA events around ``AdamW.update``, whose
elementwise kernels are part of "other" in the trace), the forward +
backward alone, tokens/s, MFU against the card's bf16 peak and the peak
memory. The full kernel table goes to DIR/profile_train.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ITERS = 3  # timed / traced steps (after 2 untimed ones)
BATCH, SEQ, LOSS_CHUNK = 4, 2048, 512
OURS = {"flash_fwd_cached_kernel": "flash_fwd",
        "flash_fwd_tc_kernel": "flash_fwd",
        "flash_bwd_dq_kernel": "flash_bwd_dq",
        "flash_bwd_dq_tc_kernel": "flash_bwd_dq",
        "flash_bwd_dkdv_kernel": "flash_bwd_dkdv",
        "flash_bwd_dkdv_tc_kernel": "flash_bwd_dkdv"}


def _group(name: str) -> str:
    for key, label in OURS.items():
        if key in name:
            return label
    lowered = name.lower()
    if "gemm" in lowered or "gemv" in lowered or "cutlass" in lowered \
            or "sm90_xmma" in lowered or "nvjet" in lowered:
        return "matmul"
    return "other"


def _events_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(
        os.path.dirname(HERE), "build", "profile"))
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA device", file=sys.stderr)
        return 1
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.training import TrainConfig, Trainer, mfu
    from mlrun_tpu_torch.training.data import (
        synthetic_token_stream,
        to_device,
    )

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    config = MODEL_PRESETS["llama3-1b"]()
    trainer = Trainer(config, TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                          total_steps=100,
                                          loss_chunk=LOSS_CHUNK), device=dev)
    trainer.init(args.seed)
    trainer.warmup(BATCH, SEQ)
    tokens, targets = to_device(next(synthetic_token_stream(
        BATCH, SEQ, config.vocab_size, seed=args.seed)), dev)

    def step():
        trainer._dispatch(tokens, targets)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    for _ in range(ITERS):
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3 / ITERS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    state = trainer.state
    holder = {}

    def fwd_bwd():
        holder["grads"], _ = trainer.step_fn.compute_grads(
            state.params, tokens, targets)

    fwd_bwd_ms = _events_ms(fwd_bwd, ITERS)
    optimizer_ms = _events_ms(lambda: trainer.optimizer.update(
        holder["grads"], state.opt_state, state.params), ITERS)
    del holder

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            step()
            torch.cuda.synchronize()
    groups: dict = {}
    busy_us = 0.0
    launches: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.time_range.elapsed_us()
        busy_us += dev_us
        label = _group(evt.name)
        groups[label] = groups.get(label, 0.0) + dev_us
        launches[label] = launches.get(label, 0) + 1
    if busy_us == 0:
        raise SystemExit("profile_torch_training: the trace holds no device "
                         "time (CUPTI tracing unavailable)")
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    with open(os.path.join(args.out, "profile_train.txt"), "w") as fh:
        fh.write(table)
    busy_ms = busy_us / 1e3 / ITERS
    tps = BATCH * SEQ / (wall_ms / 1e3)
    print(json.dumps({
        "step": "train", "model": "llama3-1b", "layers": config.n_layers,
        "batch": BATCH, "seq": SEQ, "loss_chunk": LOSS_CHUNK,
        "remat_policy": config.remat_policy, "card": card,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "device_ms_by_group": {k: v / 1e3 / ITERS
                               for k, v in sorted(groups.items())},
        "kernels_per_step_by_group": {k: v / ITERS
                                      for k, v in sorted(launches.items())},
        "optimizer_update_ms": optimizer_ms,
        "forward_backward_ms": fwd_bwd_ms,
        "tokens_per_sec": tps,
        "mfu": mfu(tps, config.flops_per_token(SEQ)),
        "peak_memory_gib": peak_gib,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
