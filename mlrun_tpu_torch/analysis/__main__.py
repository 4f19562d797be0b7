"""CLI: ``python -m mlrun_tpu_torch.analysis [paths] [--json FILE]
[--format human|json] [--list-codes]``.

Exit status 0 = zero unsuppressed findings (suppressed-with-reason is
fine), 1 = findings or parse errors — chip_smoke.py's build phase runs
it before any engine boots, so invariant drift fails fast.
"""

from __future__ import annotations

import argparse
import sys

from . import CODES
from .core import PACKAGE
from .engine import render_human, render_json, run_analysis


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mlrun_tpu_torch.analysis",
        description="mlt-lint: AST invariant checker "
                    "(docs/static_analysis.md)")
    parser.add_argument("paths", nargs="*", default=[PACKAGE],
                        help=f"files/dirs to check (default: {PACKAGE})")
    parser.add_argument("--json", metavar="FILE", default=None,
                        help="also write the full JSON report here")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human", help="stdout format")
    parser.add_argument("--list-codes", action="store_true",
                        help="print the MLT code table and exit")
    args = parser.parse_args(argv)

    if args.list_codes:
        for code, desc in sorted(CODES.items()):
            print(f"{code}  {desc}")
        return 0

    result = run_analysis(args.paths or [PACKAGE])
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fp:
            fp.write(render_json(result) + "\n")
    if args.format == "json":
        print(render_json(result))
    else:
        print(render_human(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
