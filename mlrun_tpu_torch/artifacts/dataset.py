"""Dataset artifact — the port's copy of ``mlrun_tpu/artifacts/dataset.py``."""

from __future__ import annotations

from io import BytesIO

from .base import Artifact, ArtifactSpec

default_preview_rows = 20


class DatasetArtifact(Artifact):
    kind = "dataset"
    _store_prefix = "datasets"

    def __init__(self, key=None, df=None, preview=None, format="parquet",
                 stats=None, target_path=None, **kwargs):
        super().__init__(key, target_path=target_path, format=format, **kwargs)
        self.kind = "dataset"
        self._df = df
        self.spec.extra_data = self.spec.extra_data or {}
        self.header = None
        self.preview = preview
        self.stats = stats

    def before_log(self):
        df = self._df
        if df is None:
            return
        self.header = list(map(str, df.columns)) if hasattr(df, "columns") else None
        n = self.preview if isinstance(self.preview, int) else default_preview_rows
        try:
            preview_df = df.head(n)
            self.preview = [list(map(str, row)) for row in preview_df.itertuples(index=False)]
        except Exception:
            self.preview = None
        try:
            self.stats = {
                col: {
                    "count": int(df[col].count()),
                    "mean": float(df[col].mean()) if df[col].dtype.kind in "if" else None,
                }
                for col in df.columns
            }
        except Exception:
            self.stats = None
        self.spec.extra_data["length"] = len(df)

    def to_dict(self, exclude=None):
        out = super().to_dict(exclude)
        out.setdefault("spec", {})
        for field in ("header", "preview", "stats"):
            value = getattr(self, field, None)
            if value is not None:
                out["spec"][field] = value
        return out

    def get_body(self):
        if self._body is not None:
            return self._body
        if self._df is None:
            return None
        fmt = self.spec.format or "parquet"
        buf = BytesIO()
        if fmt == "csv":
            self._df.to_csv(buf, index=False)
        else:
            self._df.to_parquet(buf, index=False)
        return buf.getvalue()

    @property
    def df(self):
        return self._df


def update_dataset_meta(artifact, from_df=None, **kwargs):
    if from_df is not None:
        artifact._df = from_df
        artifact.before_log()
    for key, value in kwargs.items():
        setattr(artifact, key, value)
    return artifact
