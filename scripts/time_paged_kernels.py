"""Time the paged attention kernels of a checkout on one GPU, two ways, so
that two commits compare on the same card with the same method.

    python3 scripts/time_paged_kernels.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``mlrun_tpu_torch`` is timed (default:
this one); unpack another commit there with ``git archive`` to time its
kernels with this script. Run parent, change, change, parent in one
session to compare two commits.

Rows (bf16 q, random inputs from ``--seed``):

- the paged rows of ``chip_smoke.py``'s kernels phase, at its shapes,
  through its own row functions (each row's checks included): decode
  native at positions 1/700/1300/2047 and 600/436/200/700, decode int8
  at 600/436/200/700, prefill native and int8 (S 512 over base 256),
  verify native and int8 (4 slots x S 5 over bases 600/436/200/700);
- the prefix sweep: a prefill of S 512 over a prefix of 256, 1024 and
  1536 tokens, native and int8, and the same rows as one verify slot,
  with whether the two give the same bits.

Each row carries ``ms`` (``chip_smoke.time_ms``: CUDA events around
back-to-back calls; a kernel shorter than its wrapper's host work reads
the host's rate), ``device_ms`` and ``host_ms`` (``chip_smoke.queued_ms``:
the same calls queued behind a sleep kernel, so the events read the
card's time alone, and the host's enqueue time a call). One JSON line a
row on standard output, tagged with ``--label``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SWEEP_S = 512
SWEEP_BASES = (256, 1024, 1536)


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def prefix_sweep(smoke, gen, emit):
    """Prefill vs one verify slot over the same prefix and rows."""
    import torch

    from mlrun_tpu_torch.ops import paged_attention as pa

    pps = smoke.MAX_LEN // smoke.PAGE
    n_pages = pps
    native_k = (torch.randn((n_pages + 1, smoke.PAGE, smoke.HKV, smoke.D),
                            generator=gen, device="cuda") * 0.5).bfloat16()
    native_v = torch.randn(native_k.shape, generator=gen,
                           device="cuda").bfloat16()
    k8, ks, v8, vs = smoke._int8_pool(gen, n_pages)
    q = torch.randn((SWEEP_S, smoke.H, smoke.D), generator=gen,
                    device="cuda").bfloat16()
    for base in SWEEP_BASES:
        ids = smoke._page_table(gen, [base], pps, n_pages)[0]
        bases = torch.tensor([base], dtype=torch.int32, device="cuda")
        for pages, k, v, scales in (
                ("native", native_k, native_v, {}),
                ("int8", k8, v8, {"k_scale": ks, "v_scale": vs})):
            def prefill():
                return pa._paged_prefill_call(q, k, v, ids, base,
                                              smoke.PAGE, **scales)

            def verify():
                return pa._paged_verify_call(q[None], k, v, ids[None],
                                             bases, smoke.PAGE, **scales)

            o, lse = prefill()
            o1, lse1 = verify()
            torch.cuda.synchronize()
            same = bool(torch.equal(o1[0], o)
                        and torch.equal(lse1[0], lse.T))
            for entry, fn in (("prefill", prefill),
                              ("one_slot_verify", verify)):
                emit({"sweep": entry, "pages": pages, "S": SWEEP_S,
                      "base": base, "same_bits": same,
                      **smoke.kernel_times(fn)})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--label", default="")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_paged_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    smoke = load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(row):
        print(json.dumps({"label": args.label, **row}), flush=True)

    # the kernels phase's rows print through chip_smoke.emit; tag them too
    smoke.emit = lambda row: emit({k: v for k, v in row.items()
                                   if k != "phase"})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    kind, dtype, record = "bf16", torch.bfloat16, []
    smoke.kernel_decode(gen, kind, dtype, record)
    smoke.kernel_decode(gen, kind, dtype, record, smoke.SERVE_POS,
                        extra=True)
    smoke.kernel_decode_int8(gen, kind, dtype, record)
    smoke.kernel_prefill(gen, kind, dtype, record)
    smoke.kernel_prefill_int8(gen, kind, dtype, record)
    smoke.kernel_verify(gen, kind, dtype, record)
    prefix_sweep(smoke, gen, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
