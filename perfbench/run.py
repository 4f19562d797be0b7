"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix and
metric readers are found by the names in ``BENCHMARK.json``. The last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``: each number compared
with its limit, also printed as the last lines on standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result. If ``jax``, ``jaxlib``, ``flax`` or ``mlrun_tpu``
is loaded when the window has closed it exits 3 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the build caches: fixed directories inside the checkout, so only the
# first run of a checkout builds
CACHE = HERE / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "mlrun_tpu")


def _environment():
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["MLT_TRAINING__COMPILE_CACHE_DIR"] = str(CACHE / "kernels")
    for path in (str(HERE), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port's benchmark
    must never load."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             started: float, **kwargs) -> dict:
    """Drive the cell once on ``device``; returns the run's record."""
    kind = cell.traffic["kind"]
    if kind == "packed_documents":
        import train_cell

        return train_cell.run(cell, seed, seconds, trace, device, started,
                              **kwargs)
    import serve_cell

    return serve_cell.run(cell, seed, seconds, trace, device, started,
                          **kwargs)


def _finite(value):
    return isinstance(value, (int, float)) and math.isfinite(value)


def result_line(cell, run: dict, trace: bool, device_info: dict,
                root: Path = ROOT) -> dict:
    import cells

    metrics = cells.read_metrics(cell.per_layer if trace else
                                 cell.end_to_end, run, root)
    dropped = [k for k, v in metrics.items() if not _finite(v["value"])]
    for key in dropped:
        print(f"perfbench: {key} read {metrics[key]['value']}; left out",
              file=sys.stderr)
        del metrics[key]
    check = run["check"]
    if run["kind"] == "serve":
        window = [r for r in run["requests"] if r["in_window"]]
        attempted = len(window)
        failed = sum(1 for r in window if r["ok"] is False
                     and not r["stopped"])
    else:
        attempted, failed = run["steps_in_window"], run["failed_steps"]
    device = dict(device_info)
    device["memory_peak_bytes"] = run["memory_peak_bytes"]
    line = {"correct": bool(check["correct"]), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device}
    if trace and run.get("trace"):
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
        line["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                             "idle_gaps": run["trace"]["idle_gaps"]}
    line["check"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                     for n in check["numbers"]}
    return line


def _card() -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else ""
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unread"
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    import cells

    cell = cells.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    from mlrun_tpu_torch.utils import compile_cache

    compile_cache.configure(str(CACHE / "kernels"))
    card = _card()
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   STARTED)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    device_info = {"platform": card["platform"], "kind": card["kind"],
                   "count": cell.chips}
    line = result_line(cell, run, bool(args.trace), device_info)
    marks = run["setup_marks"]
    steps = ", ".join(f"{name} {t - marks[i][1]:.2f}"
                      for i, (name, t) in enumerate(marks[1:]))
    print(f"perfbench: card {card['kind']}, power limit "
          f"{card['power_limit']}; setup_s {run['setup_s']:.3f} ({steps})",
          file=sys.stderr)
    for name, entry in line["check"].items():
        print(f"check {name}: {entry['value']} (limit {entry['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
