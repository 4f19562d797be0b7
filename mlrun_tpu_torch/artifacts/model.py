"""``get_model`` — counterpart of ``mlrun_tpu/artifacts/model.py``'s."""

from __future__ import annotations

import os


def get_model(model_dir: str, suffix: str = "") -> tuple[str, None, dict]:
    """Resolve a model directory, file or datastore url to (local model
    file, model spec, extra data). A directory gives its first entry
    ending in ``suffix``; anything else resolves through the datastore.
    A ``store://`` artifact uri needs the run db and raises ``not_ported``
    item 10, so the spec is always None and the extra data empty."""
    from ..datastore import store_manager

    if os.path.isdir(model_dir):
        candidates = [f for f in os.listdir(model_dir)
                      if not suffix or f.endswith(suffix)]
        if not candidates:
            raise FileNotFoundError(f"no model file found in {model_dir}")
        return os.path.join(model_dir, candidates[0]), None, {}
    return store_manager.object(url=model_dir).local(), None, {}
