"""Readings that set the benchmark's limits and rate, run on the chip:

    python3 perfbench/calibrate.py seeds --workload <name> \
        --seeds 11,12,13 --seconds 15 [--control fp8] [--fault half_batch]
    python3 perfbench/calibrate.py sweep --workload <name> --seed 5 \
        --seconds 30 --rates 2,4,6,8

``seeds`` runs the cell once a seed in one process and prints, a JSON
line a seed, every number the check compares (with ``--control`` also
the lower-precision reference's reading on the same requests or rows;
with ``--fault`` the reading of the timed path with that fault planted).
``sweep`` runs an open-loop serving cell at each request rate and prints
whether completions kept pace with arrivals: the knee is the highest rate
at which they did.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import run as runmod


def _faults(name: str):
    """A fault planted in the timed path, by name."""
    if name == "half_batch":
        def plant(trainer):
            step = trainer.step_fn

            def half(state, tokens, targets):
                keep = tokens.shape[1] // 2
                return step(state, tokens[:, :keep], targets[:, :keep])

            half.compute_grads = step.compute_grads
            trainer.step_fn = half
        return plant
    if name == "frozen_state":
        def plant(trainer):
            step = trainer.step_fn

            def frozen(state, tokens, targets):
                saved = {id(p): p.detach().clone()
                         for p in _leaves(state.params)}
                state, metrics = step(state, tokens, targets)
                for p in _leaves(state.params):
                    p.data.copy_(saved[id(p)])
                return state, metrics

            frozen.compute_grads = step.compute_grads
            trainer.step_fn = frozen
        return plant
    if name == "altered_token":
        def plant(engine):
            tick = engine._plain_decode_tick

            def altered(active):
                done = tick(active)
                for i in active:
                    slot = engine._slot_state[i]
                    if slot.active and len(slot.tokens) == 3:
                        slot.tokens[-1] = (slot.tokens[-1] + 1) % \
                            engine.config.vocab_size
                return done

            engine._plain_decode_tick = altered
        return plant
    raise ValueError(f"unknown fault {name!r}")


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def seeds(args, cell, device) -> None:
    fault = _faults(args.fault) if args.fault else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        started = time.perf_counter()
        record = runmod.run_cell(cell, seed, args.seconds, False, device,
                                 started, check_limit=False, fault=fault,
                                 control=args.control)
        check = record["check"]
        line = {"workload": cell.name, "seed": seed, "fault": args.fault,
                "numbers": check["numbers"], "control": check.get("control"),
                "setup_s": record["setup_s"],
                "memory_peak_bytes": record["memory_peak_bytes"],
                "wall_s": time.perf_counter() - started}
        if record["kind"] == "train":
            line["readings"] = check["readings"]
            line["losses"] = check["losses"]
            line["left_out"] = check["left_out"]
            line["steps_in_window"] = record["steps_in_window"]
        print(json.dumps(line), flush=True)


def sweep(args, cell, device) -> None:
    import readers

    for rate in [float(r) for r in args.rates.split(",")]:
        cell_at = copy.deepcopy(cell)
        cell_at.traffic["request_rate_per_s"] = rate
        cell_at.traffic["check"]["sample"] = 1
        started = time.perf_counter()
        record = runmod.run_cell(cell_at, args.seed, args.seconds, False,
                                 device, started, check_limit=False)
        due = [r for r in record["requests"] if r["in_window"]]
        done_in = [r for r in due if r["ok"] and r["done"] < record["t1"]]
        late = [r for r in due if r["ok"] and r["done"] >= record["t1"]]
        half = record["t0"] + record["window_s"] / 2
        waits = {part: readers.percentile(
            [r["queue_wait_s"] * 1e3 for r in due if r["ok"]
             and (r["due"] < half) == (part == "first")], 95)
            for part in ("first", "second")}
        print(json.dumps({
            "workload": cell.name, "rate": rate, "due": len(due),
            "completed_in_window": len(done_in),
            "completed_after": len(late),
            "ttft_p95_ms": readers.ttft_p95_ms(record),
            "tpot_p95_ms": readers.tpot_p95_ms(record),
            "queue_wait_p95_ms_first_half": waits["first"],
            "queue_wait_p95_ms_second_half": waits["second"],
            "decode_tick_ms": readers.decode_tick_ms(record),
            "tokens_per_s": readers.served_tokens_per_s(record)}),
            flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("seeds", "sweep"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--rates", default="")
    parser.add_argument("--control", default=None)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    runmod._environment()
    import cells

    try:
        cell = cells.resolve(args.workload)
    except KeyError:
        cell = cells.from_files(*args.workload.split(".", 1))
    from mlrun_tpu_torch.utils import compile_cache

    compile_cache.configure(str(runmod.CACHE / "kernels"))
    (seeds if args.mode == "seeds" else sweep)(args, cell, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
