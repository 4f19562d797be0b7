"""The traced run's reading of the device: ``torch.profiler`` over a
steady part of the window, reduced to busy seconds (the union of the
device's kernel intervals), the traced window's length, kernel time by
name, and the idle gaps labelled by what the host was doing.

The profiler is started and stopped on one thread (the caller's); a
profile stopped off its starting thread can crash the process.
"""

from __future__ import annotations

import time

SPAN_PREFIX = "perfbench."
# the largest gaps, whose labels also name the innermost host op
LABELLED_GAPS = 300


class DeviceTrace:
    """``start()`` then ``stop()`` on the same thread; ``summary()``
    afterwards."""

    def __init__(self):
        self._prof = None
        # host times: the start call began, the trace began, the trace
        # ended, the stop call returned
        self.t_begin = self.t_start = self.t_stop = self.t_done = None

    def prime(self):
        """One empty profile during set-up: the profiler's first start
        initialises its tracer, which takes seconds; the window's start
        then does not."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.t_begin = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t_start = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.t_done = time.perf_counter()

    @property
    def active(self) -> bool:
        return self._prof is not None and self.t_stop is None

    def summary(self) -> dict:
        """busy_s, window_s, kernels {name: {"count", "seconds"}},
        device_ops (the 10 costliest names) and idle_gaps (gap seconds by
        the harness span the host was in, and for the largest gaps the
        innermost host op; the 10 largest sums)."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        kernels, host = [], []
        for evt in self._prof.events():
            span = (evt.time_range.start, evt.time_range.end)
            if evt.name.startswith(SPAN_PREFIX):
                # a harness span: on the host timeline, and mirrored on
                # the device's as an annotation, which is no kernel
                if evt.device_type != cuda:
                    host.append((span[0], span[1], evt.name))
            elif evt.device_type == cuda:
                kernels.append((span[0], span[1], evt.name))
            else:
                host.append((span[0], span[1], evt.name))
        window_s = self.t_stop - self.t_start
        by_name: dict = {}
        for start, end, name in kernels:
            entry = by_name.setdefault(name, {"count": 0, "seconds": 0.0})
            entry["count"] += 1
            entry["seconds"] += (end - start) / 1e6
        merged = _union(sorted((s, e) for s, e, _ in kernels))
        busy_s = sum(e - s for s, e in merged) / 1e6
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)
                if merged[i + 1][0] > merged[i][1]]
        labelled: dict = {}
        host.sort()
        spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in host]
        for i, (start, end) in enumerate(gaps):
            at = (start + end) / 2
            label = _covering(spans, at) or "outside the harness's spans"
            if i < LABELLED_GAPS:
                label += ": " + _innermost(host, starts, at)
            labelled[label] = labelled.get(label, 0.0) + (end - start) / 1e6
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1]["seconds"])
        return {
            "busy_s": busy_s, "window_s": window_s,
            "kernels": by_name,
            "device_ops": [[_short(n), v["seconds"]] for n, v in top_ops[:10]],
            "idle_gaps": sorted(([k, v] for k, v in labelled.items()),
                                key=lambda kv: -kv[1])[:10],
        }


def _union(spans: list) -> list:
    out: list = []
    for start, end in spans:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _covering(spans: list, at: float):
    """The name of the harness span (``perfbench.*``) covering ``at``."""
    for start, end, name in spans:
        if start <= at <= end:
            return name
    return None


def _innermost(host: list, starts: list, at: float) -> str:
    """The innermost of the host ops that started shortly before ``at``
    and cover it, else ``host``."""
    import bisect

    best = None
    hi = bisect.bisect_right(starts, at)
    for start, end, name in host[max(0, hi - 2000):hi]:
        if end >= at and not name.startswith(SPAN_PREFIX) and (
                best is None or end - start < best[1] - best[0]):
            best = (start, end, name)
    return best[2] if best else "host"


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def kernel_stats(summary: dict, *needles: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds any of
    ``needles``."""
    count, seconds = 0, 0.0
    for name, entry in summary["kernels"].items():
        if any(n in name for n in needles):
            count += entry["count"]
            seconds += entry["seconds"]
    return count, seconds
