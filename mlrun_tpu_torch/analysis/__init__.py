"""mlt-lint for the port: the AST invariant checker of the reference's
``analysis/`` (docs/static_analysis.md), holding ``mlrun_tpu_torch/`` to
the port's own conventions.

Stdlib-only (ast + tokenize). Run it:

    python -m mlrun_tpu_torch.analysis mlrun_tpu_torch/   # human output
    python -m mlrun_tpu_torch.analysis mlrun_tpu_torch --format json

Codes:

- MLT000 malformed/unreasoned suppression comment
- MLT001 chaos coherence (fire()/FaultPoints/docs agreement)
- MLT002 metrics discipline (one ctor site, label keys, retire, docs)
- MLT003 explicit-now in control loops (fake-clock testability)
- MLT004 blocking call under an engine lock (torch device syncs among
  the blocking calls)
- MLT005 typed errors on the serving request path
- MLT006 config key chains resolve against config.py's ``*_DEFAULTS``
  (``run_config``, ``service_config`` and the dicts' subscripts)

Suppress one finding inline with ``# mlt: ignore[MLT0xx]: reason`` —
the reason is required. Structural exceptions go in each checker's
ALLOWLIST table with a one-line rationale.
"""

from .core import (  # noqa: F401
    Checker,
    Finding,
    SUPPRESSION_CODE,
    parse_suppressions,
)
from .engine import (  # noqa: F401
    AnalysisResult,
    default_checkers,
    iter_py_files,
    render_human,
    render_json,
    run_analysis,
)

CODES = {
    "MLT000": "malformed or unreasoned suppression comment",
    "MLT001": "chaos coherence: fire()/FaultPoints/docs agreement",
    "MLT002": "metrics discipline: ctor sites, label keys, retire, docs",
    "MLT003": "explicit-now: no wall clock in control-loop modules",
    "MLT004": "blocking call (torch device sync included) under an "
              "engine lock",
    "MLT005": "typed errors on the serving request path",
    "MLT006": "config key chains resolve against config.py's *_DEFAULTS",
}
