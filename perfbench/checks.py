"""How ``correct`` is decided: what the timed path produced, compared
with the plain reference under ``reference/``, each number beside its
limit.

Serving: a sample drawn from the seed of the requests the window
finished, the longest among them; the reference runs once over each
prompt with its served tokens, and the number is the widest gap by which
a served token's logit lies below the reference's best at its position.

Training: see ``train_check``.

A limit of None (not yet set from its readings) makes the run report the
number and count it as not correct.
"""

from __future__ import annotations

import importlib

import numpy as np


def reference_module(config: dict):
    return importlib.import_module(f"reference.{config['reference']}")


def sample_requests(records: list, n: int, seed: int) -> list:
    """The longest finished request (prompt plus served tokens) and
    n - 1 others drawn from the seed, each finished with at least one
    served token."""
    done = [r for r in records if r["ok"] and r.get("generated", 0) >= 1
            and r.get("in_window", True)]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: done[i]["prompt_len"] + done[i]["generated"])
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(int(seed) % (1 << 64) ^ 0xC4EC)
    picked = [longest] + list(rng.permutation(rest)[:max(0, n - 1)])
    return [done[i] for i in picked]


def serve_gaps(cell, sizes: dict, params: dict, sample: list,
               quant=None) -> dict:
    ref = reference_module(cell.config)
    worst, tokens = 0.0, 0
    for rec in sample:
        got = ref.served_gaps(sizes, params, rec["req"].prompt, rec["tokens"],
                              quant=quant)
        worst = max(worst, got["max_gap"])
        tokens += got["tokens"]
    return {"max_gap_logit": worst, "tokens": tokens,
            "requests": len(sample)}


def serve_check(cell, sizes: dict, params: dict, records: list, seed: int,
                check_limit: bool = True, control: str | None = None
                ) -> dict:
    """The check of a serving run; with ``control`` (a lower precision)
    also the control's reading on the same sample."""
    spec = cell.traffic["check"]
    sample = sample_requests(records, spec["sample"], seed)
    failed = [r for r in records if r["ok"] is False and not r["stopped"]]
    reading = serve_gaps(cell, sizes, params, sample) if sample else None
    limit = spec.get("max_gap_logit")
    numbers = []
    ok = bool(sample) and not failed
    if reading is not None:
        numbers.append({"name": "max_gap_logit",
                        "value": reading["max_gap_logit"], "limit": limit})
        ok = ok and limit is not None and \
            reading["max_gap_logit"] <= limit
    numbers.append({"name": "failed_requests", "value": len(failed),
                    "limit": 0})
    out = {"correct": bool(ok) if check_limit else None,
           "numbers": numbers, "sample": len(sample),
           "checked_tokens": reading["tokens"] if reading else 0}
    if control and sample:
        out["control"] = serve_gaps(cell, sizes, params, sample, control)
    return out


# -- training -----------------------------------------------------------------

SAMPLE = 1 << 20       # elements a leaf's gradient sample holds at most


def sample(leaf):
    """Every k-th element of the flattened leaf (k = numel // 2**20, at
    least 1), in float32: the same positions on both sides."""
    flat = leaf.reshape(-1)
    return flat[::max(1, flat.numel() // SAMPLE)].float()


def leaf_diffs(prog: dict, ref: dict) -> dict:
    """Each leaf's norm of the difference between the program's sample
    and the reference's, over the reference's sampled norm of that leaf
    or of the median leaf, whichever is larger."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    median = float(np.median(list(norms.values())))
    return {key: float((prog[key].float() - want.float()).norm())
            / max(norms[key], median) for key, want in ref.items()}

def rel_gap(a: float, b: float, floor: float) -> float:
    """|a - b| over max(|b|, floor)."""
    return abs(a - b) / max(abs(b), floor)


def worst_leaf(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    keys = [k for k in ref if k not in skip]
    median = float(np.median([ref[k] for k in keys])) if keys else 0.0
    worst, which = 0.0, ""
    for key in keys:
        gap = rel_gap(prog[key], ref[key], median)
        if gap > worst:
            worst, which = gap, key
    return worst, which


def train_check(cell, prog: dict, ref: dict, check_limit: bool = True
                ) -> dict:
    """The first gradient (as AdamW got it: its first moment after one
    step over 1 - b1) against the reference's, by the norm of their
    difference on a fixed sample of each leaf, the median leaf's (the
    worst leaf, the router, swings with the routing's near-ties), and the
    norm of each leaf's change after the checked steps by the worst leaf,
    program against reference. Each step's loss, the gap of the first
    gradient's norms and the worst leaf's difference are read beside them
    and not compared (PERF.md).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    spec = cell.traffic["check"]
    grads = ref["grad_norms"]
    median = float(np.median(list(grads.values())))
    still = {k for k, v in grads.items() if v < 1e-3 * median}
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program losses against "
                         f"{len(ref['losses'])} reference steps")
    diffs = leaf_diffs(prog["grad_samples"], ref["grad_samples"])
    worst_diff_leaf = max(diffs, key=diffs.get)
    change_gap, change_leaf = worst_leaf(prog["change_norms"],
                                         ref["change_norms"], skip=still)
    numbers = [
        {"name": "grad_diff_rel", "value": float(np.median(
            list(diffs.values()))), "limit": spec["grad_diff_rel"]},
        {"name": "change_rel", "value": change_gap,
         "limit": spec["change_rel"], "leaf": change_leaf},
    ]
    ok = all(n["value"] <= n["limit"] for n in numbers)
    # read, not compared: no control or fault separates them from sound
    # runs (PERF.md gives their readings)
    grad_gap, grad_leaf = worst_leaf(prog["grad_norms"], grads)
    loss_gap = max(rel_gap(p, r, 1e-6) for p, r in
                   zip(prog["losses"], ref["losses"]))
    return {"correct": bool(ok) if check_limit else None,
            "numbers": numbers, "left_out": sorted(still),
            "readings": {"loss_rel": loss_gap, "grad_rel": grad_gap,
                         "grad_rel_leaf": grad_leaf,
                         "grad_diff_worst": diffs[worst_diff_leaf],
                         "grad_diff_worst_leaf": worst_diff_leaf,
                         "grad_diff_by_leaf": diffs},
            "losses": {"program": prog["losses"], "reference": ref["losses"]}}
