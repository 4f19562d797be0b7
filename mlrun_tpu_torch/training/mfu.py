"""MFU accounting — model FLOPs utilization vs the card's peak, and the
steady-state throughput window behind ``tokens_per_sec``/``mfu`` in
``Trainer.fit``. Counterpart of ``mlrun_tpu/training/mfu.py`` with an
NVIDIA peak table (``Trainer.fit`` sets the ``mlt_training_mfu`` gauge)."""

from __future__ import annotations

import time

import torch

# peak dense bf16 FLOP/s per card, matched against
# torch.cuda.get_device_name (first match wins: the more specific names
# come first). NVIDIA's data sheets, dense tensor-core rates.
PEAK_FLOPS = {
    "h100 pcie": 756e12,
    "h100": 989e12,        # SXM (the "H100 80GB HBM3" part)
    "h200": 989e12,
    "a100": 312e12,
    "cpu": 1e12,           # nominal, keeps the math defined on the CPU
}


def chip_peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of ``device`` (default: CUDA device 0 when
    there is one, else the CPU's nominal value)."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", 0) if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return PEAK_FLOPS["cpu"]
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_FLOPS.items():
        if key in name:
            return peak
    return PEAK_FLOPS["h100"]


def mfu(tokens_per_sec: float, flops_per_token: float,
        n_chips: int = 1, device=None) -> float:
    peak = chip_peak_flops(device) * n_chips
    return (tokens_per_sec * flops_per_token) / peak


class ThroughputTracker:
    """Steady-state tokens/sec window for the training loop.

    Dividing total tokens by total elapsed time folds the first step's
    kernel build into the rate, understating throughput (and MFU) for any
    run short enough to care about. The tracker excludes the first
    ``warmup_excluded`` steps from the window: ``note_step`` is called
    after each step returns, so the steady window starts once build-class
    host stalls are behind us. Build time itself is reported separately
    (``compile_seconds``).
    """

    def __init__(self, warmup_excluded: int = 1):
        self.warmup_excluded = max(0, int(warmup_excluded))
        self.steps = 0
        self.tokens_total = 0
        self._t_start = time.perf_counter()
        self._t_steady: float | None = (
            self._t_start if self.warmup_excluded == 0 else None)
        self._tokens_at_steady = 0

    def note_step(self, tokens: int):
        self.steps += 1
        self.tokens_total += int(tokens)
        if self._t_steady is None and self.steps >= self.warmup_excluded:
            self._t_steady = time.perf_counter()
            self._tokens_at_steady = self.tokens_total

    @property
    def in_steady_state(self) -> bool:
        return (self._t_steady is not None
                and self.tokens_total > self._tokens_at_steady)

    def tokens_per_sec(self) -> float:
        """Steady-state rate; falls back to the whole-run rate while the
        warmup window hasn't produced a measurable steady interval."""
        now = time.perf_counter()
        if self.in_steady_state:
            elapsed = now - self._t_steady
            tokens = self.tokens_total - self._tokens_at_steady
        else:
            elapsed = now - self._t_start
            tokens = self.tokens_total
        return tokens / elapsed if elapsed > 0 else 0.0
