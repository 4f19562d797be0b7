"""Shared arithmetic of the metric readers under ``metrics/``: each
reader is a small file that picks what it reads from a run's record and
hands it to one of these. A reader that finds nothing to read returns
None, and the harness leaves that metric out of the line."""

from __future__ import annotations

import math

import roofline
from devtrace import kernel_stats


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in 0..100) of ``values``; inf
    counts as larger than any number."""
    ordered = sorted(values)
    if not ordered:
        return float("nan")
    return float(ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1])


def in_window(run: dict) -> list:
    return [r for r in run["requests"] if r["in_window"]]


def untraced(run: dict, start: float, end: float | None = None) -> bool:
    """Whether [start, end] misses the traced run's profiler (its start
    and stop calls included), which slows the host: the host-side
    per-layer readings of a traced run leave that stretch out."""
    span = run.get("trace_cost_span")
    end = start if end is None else end
    return span is None or end < span[0] or start > span[1]


def ttft_p95_ms(run: dict):
    """95th percentile of time to first token from when each request was
    due, over every request due in the window; a failed one counts as
    never answered."""
    if run.get("kind") != "serve":
        return None
    values = [(r["first"] - r["due"]) * 1e3 if r["ok"] and "first" in r
              else float("inf") for r in in_window(run) if not r["stopped"]]
    return percentile(values, 95) if values else None


def tpot_p95_ms(run: dict):
    """95th percentile, over requests completed in the window, of
    (completion - first token) / (tokens - 1)."""
    if run.get("kind") != "serve":
        return None
    values = [(r["total_s"] - r["ttft_s"]) / (r["generated"] - 1) * 1e3
              for r in run["requests"] if r["ok"] and r["generated"] > 1
              and run["t0"] <= r["done"] < run["t1"]]
    return percentile(values, 95) if values else None


def window_ticks(run: dict, start=None, stop=None) -> list:
    start = run["t0"] if start is None else start
    stop = run["t1"] if stop is None else stop
    return [t for t in run["ticks"] if start <= t[1] < stop]


def served_tokens_per_s(run: dict):
    """Tokens the engine emitted in the window (first tokens from
    prefills plus one a row a decode tick) over the window's seconds."""
    if run.get("kind") != "serve":
        return None
    tokens = len(run["firsts"]) + sum(t[2] for t in window_ticks(run))
    return tokens / run["window_s"]


def generator_lag_p95_ms(run: dict):
    values = [(r["sent"] - r["due"]) * 1e3 for r in in_window(run)
              if untraced(run, r["due"], r["sent"])]
    return percentile(values, 95) if values else None


def prefix_hit_rate(run: dict):
    queries = run["stats1"]["prefix_queries"] - run["stats0"]["prefix_queries"]
    if queries <= 0:
        return None
    return (run["stats1"]["prefix_hits"] - run["stats0"]["prefix_hits"]) \
        / queries


def queue_wait_p95_ms(run: dict):
    values = [r["queue_wait_s"] * 1e3 for r in in_window(run)
              if r["ok"] and "queue_wait_s" in r
              and untraced(run, r["sent"], r["sent"] + r["queue_wait_s"])]
    return percentile(values, 95) if values else None


def decode_tick_ms(run: dict):
    """Median of the engine's decode-tick ring over the window (one
    entry a tick, in step with the harness's tick records)."""
    ring = run.get("tick_ring") or []
    if len(ring) == len(run["ticks"]):
        ring = [seconds for seconds, (start, end, _, _) in
                zip(ring, run["ticks"]) if untraced(run, start, end)]
    return percentile(ring, 50) * 1e3 if ring else None


def decode_mfu(run: dict):
    """The decode ticks' FLOPs in the window (2 a matmul weight a row,
    q.k and p.v over each row's live positions) over the window's
    seconds and the bf16 peak, in percent."""
    s = run["sizes"]
    ticks = window_ticks(run)
    if not ticks:
        return None
    per_row = 2 * roofline.dense_matmul_params(s)
    attn = 4 * s["head_dim"] * s["n_heads"] * s["n_layers"]
    flops = sum(rows * per_row + live * attn for _, _, rows, live in ticks)
    return 100.0 * flops / run["window_s"] / roofline.PEAK_FLOPS["bf16"]


def paged_decode_roofline(run: dict):
    """Bytes-bound time of the paged-decode launches in the traced span
    (each live position's KV read once, at the pool's dtype) over their
    device time, in percent: the mean bound a launch over the mean
    device time a launch."""
    trace = run.get("trace")
    if not trace or not run.get("trace_span"):
        return None
    launches, seconds = kernel_stats(trace, "paged_decode_kernel")
    ticks = window_ticks(run, *run["trace_span"])
    if not launches or not ticks:
        return None
    s, eng = run["sizes"], run["engine"]
    pps = eng["max_len"] // eng["page_size"]
    bound = 0.0
    for _, _, rows, live in ticks:
        n_bytes = roofline.paged_decode_bytes(
            live, eng["slots"], s["n_heads"], s["n_kv_heads"], s["head_dim"],
            pps, 2)
        bound += roofline.bound_s(n_bytes, roofline.paged_decode_ops(
            live, s["n_heads"], s["head_dim"]))[0]
    per_launch_bound = bound / len(ticks)
    return 100.0 * per_launch_bound / (seconds / launches)


def idle_share(run: dict):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return max(0.0, 1.0 - trace["busy_s"] / trace["window_s"])


def train_tokens_per_s(run: dict):
    """Tokens of every optimizer step finished in the window over the
    window's seconds (the window ends with a synchronise)."""
    if run.get("kind") != "train":
        return None
    return run["tokens_in_window"] / run["window_s"]


def train_mfu(run: dict):
    """The window's training FLOPs (6 a weight a token over the active
    weights, plus the causal attention; nothing recomputed counts) over
    its seconds and the bf16 peak, in percent."""
    rate = train_tokens_per_s(run)
    if not rate:
        return None
    flops = roofline.train_token_flops(run["sizes"], run["seq"])
    return 100.0 * rate * flops / roofline.PEAK_FLOPS["bf16"]


def flash_roofline(run: dict):
    """The bound time of the traced flash launches (csrc/flash_fwd_tc.cu
    and csrc/flash_bwd_tc.cu: 4 D operations a causal pair forward, 10 D
    backward, or their bytes if larger) over their device time, in
    percent. A backward is one dq and one dk/dv launch."""
    trace = run.get("trace")
    if not trace:
        return None
    fwd_n, fwd_s = kernel_stats(trace, "flash_fwd_tc_kernel")
    bwd_n, bwd_s = kernel_stats(trace, "flash_bwd_dq_tc_kernel")
    _, dkdv_s = kernel_stats(trace, "flash_bwd_dkdv_tc_kernel")
    if not fwd_n or not (fwd_s + bwd_s + dkdv_s):
        return None
    s = run["sizes"]
    b, seq, h, hkv, d = (run["batch"], run["seq"], s["n_heads"],
                         s["n_kv_heads"], s["head_dim"])
    pairs = roofline.attention_pairs(True, b, seq, h)
    fwd = roofline.bound_s(roofline.flash_fwd_bytes(b, seq, h, hkv, d, 2),
                           roofline.flash_fwd_ops(pairs, d))[0]
    bwd = roofline.bound_s(roofline.flash_bwd_bytes(b, seq, h, hkv, d, 2),
                           roofline.flash_bwd_ops(pairs, d))[0]
    return 100.0 * (fwd_n * fwd + bwd_n * bwd) / (fwd_s + bwd_s + dkdv_s)
