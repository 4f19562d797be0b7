"""Evaluation artifact plans — the port's copy of
``mlrun_tpu/frameworks/_common/plans.py`` (ConfusionMatrixPlan,
ROCCurvePlan, CalibrationCurvePlan, FeatureImportancePlan, ResidualsPlan
and the producer flow).

Each plan decides whether it applies to a (model, data) pair and produces
one artifact — an html plot (matplotlib, gated) or a dataset table — into
the run context. ``produce_artifacts`` is the producer: it runs every
applicable plan and tolerates individual failures.
"""

from __future__ import annotations

import tempfile
from typing import Any, Optional

from ...utils import logger


def _is_classifier(model, y_pred) -> bool:
    import numpy as np

    if hasattr(model, "predict_proba"):
        return True
    # integer/bool OR string/object labels mean classification
    return np.asarray(y_pred).reshape(-1).dtype.kind in "iubUOS"


def _save_figure(fig, key: str) -> str:
    path = tempfile.NamedTemporaryFile(
        suffix=f"-{key}.html", delete=False).name
    import base64
    import io

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=110)
    encoded = base64.b64encode(buf.getvalue()).decode()
    with open(path, "w") as fp:
        fp.write(f'<img src="data:image/png;base64,{encoded}"/>')
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


class ArtifactPlan:
    """One evaluation artifact: applicability test + production."""

    key = "artifact"

    def is_applicable(self, model, y, y_pred) -> bool:
        raise NotImplementedError

    def produce(self, context, model, x, y, y_pred):
        raise NotImplementedError

    def safe_produce(self, context, model, x, y, y_pred) -> bool:
        try:
            if not self.is_applicable(model, y, y_pred):
                return False
            self.produce(context, model, x, y, y_pred)
            return True
        except Exception as exc:  # noqa: BLE001 - one plan's failure must
            # not break the training run
            logger.warning("artifact plan failed", plan=self.key,
                           error=str(exc))
            return False


class ConfusionMatrixPlan(ArtifactPlan):
    key = "confusion_matrix"

    def is_applicable(self, model, y, y_pred):
        return _is_classifier(model, y_pred)

    def produce(self, context, model, x, y, y_pred):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np
        from sklearn.metrics import confusion_matrix

        labels = np.unique(np.concatenate(
            [np.asarray(y).reshape(-1), np.asarray(y_pred).reshape(-1)]))
        cm = confusion_matrix(y, y_pred, labels=labels)
        fig, ax = plt.subplots(figsize=(4, 4))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(labels)), labels)
        ax.set_yticks(range(len(labels)), labels)
        ax.set_xlabel("predicted")
        ax.set_ylabel("actual")
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center")
        fig.colorbar(im, ax=ax, fraction=0.046)
        context.log_artifact(self.key, local_path=_save_figure(fig, self.key),
                             format="html")


class ROCCurvePlan(ArtifactPlan):
    key = "roc_curve"

    def is_applicable(self, model, y, y_pred):
        import numpy as np

        return (hasattr(model, "predict_proba")
                and len(np.unique(np.asarray(y).reshape(-1))) == 2)

    def produce(self, context, model, x, y, y_pred):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.metrics import auc, roc_curve

        scores = model.predict_proba(x)[:, 1]
        fpr, tpr, _ = roc_curve(y, scores)
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.plot(fpr, tpr, label=f"AUC = {auc(fpr, tpr):.3f}")
        ax.plot([0, 1], [0, 1], "--", color="gray")
        ax.set_xlabel("false positive rate")
        ax.set_ylabel("true positive rate")
        ax.legend()
        context.log_artifact(self.key, local_path=_save_figure(fig, self.key),
                             format="html")
        context.log_result("auc", float(auc(fpr, tpr)))


class CalibrationCurvePlan(ArtifactPlan):
    key = "calibration_curve"

    def is_applicable(self, model, y, y_pred):
        import numpy as np

        return (hasattr(model, "predict_proba")
                and len(np.unique(np.asarray(y).reshape(-1))) == 2)

    def produce(self, context, model, x, y, y_pred):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.calibration import calibration_curve

        prob = model.predict_proba(x)[:, 1]
        frac_pos, mean_pred = calibration_curve(y, prob, n_bins=10)
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.plot(mean_pred, frac_pos, marker="o")
        ax.plot([0, 1], [0, 1], "--", color="gray")
        ax.set_xlabel("mean predicted probability")
        ax.set_ylabel("fraction of positives")
        context.log_artifact(self.key, local_path=_save_figure(fig, self.key),
                             format="html")


class FeatureImportancePlan(ArtifactPlan):
    key = "feature_importance"

    def is_applicable(self, model, y, y_pred):
        return hasattr(model, "feature_importances_") or \
            hasattr(model, "coef_")

    def produce(self, context, model, x, y, y_pred):
        import numpy as np
        import pandas as pd

        if hasattr(model, "feature_importances_"):
            scores = np.asarray(model.feature_importances_)
        else:
            scores = np.abs(np.asarray(model.coef_))
            if scores.ndim > 1:
                scores = scores.mean(axis=0)
        names = list(getattr(x, "columns", range(len(scores))))
        table = pd.DataFrame({"feature": [str(n) for n in names],
                              "importance": scores})
        table = table.sort_values("importance", ascending=False)
        context.log_dataset(self.key, df=table, format="parquet")


class ResidualsPlan(ArtifactPlan):
    key = "residuals"

    def is_applicable(self, model, y, y_pred):
        return not _is_classifier(model, y_pred)

    def produce(self, context, model, x, y, y_pred):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        y = np.asarray(y).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.scatter(y_pred, y - y_pred, s=8, alpha=0.6)
        ax.axhline(0.0, color="gray", linestyle="--")
        ax.set_xlabel("predicted")
        ax.set_ylabel("residual")
        context.log_artifact(self.key, local_path=_save_figure(fig, self.key),
                             format="html")


DEFAULT_CLASSIFICATION_PLANS = (ConfusionMatrixPlan, ROCCurvePlan,
                                CalibrationCurvePlan, FeatureImportancePlan)
DEFAULT_REGRESSION_PLANS = (ResidualsPlan, FeatureImportancePlan)


def produce_artifacts(context, model, x, y, y_pred=None,
                      plans: Optional[list] = None,
                      key_suffix: str = "") -> list[str]:
    """Run every applicable plan; returns the keys that produced
    artifacts (the producer flow of the reference's _common package).
    ``key_suffix`` distinguishes repeated productions (e.g. the
    EvalPlanCallback's per-epoch runs: 'confusion-matrix-epoch3')."""
    if y_pred is None:
        y_pred = model.predict(x)
    if plans is None:
        classes = (DEFAULT_CLASSIFICATION_PLANS
                   if _is_classifier(model, y_pred)
                   else DEFAULT_REGRESSION_PLANS)
        plans = [cls() for cls in classes]
    produced = []
    for plan in plans:
        original_key = plan.key
        if key_suffix:
            plan.key = f"{original_key}{key_suffix}"
        try:
            if plan.safe_produce(context, model, x, y, y_pred):
                produced.append(plan.key)
        finally:
            plan.key = original_key
    return produced
