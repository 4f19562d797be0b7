"""Pandas packagers — the port's copy of
``mlrun_tpu/package/packagers/pandas_packagers.py`` (DataFrame / Series
with parquet / csv / json file formats; pandas is imported only when a
packager is asked)."""

from __future__ import annotations

from .default import DefaultPackager


class PandasDataFramePackager(DefaultPackager):
    artifact_types = ("dataset", "artifact", "file", "result")
    default_artifact_type = "dataset"
    priority = 2

    def can_pack(self, obj):
        import pandas as pd

        return isinstance(obj, pd.DataFrame)

    def can_unpack(self, hint):
        import pandas as pd

        return hint is pd.DataFrame

    def pack(self, context, obj, key, artifact_type="", **cfg):
        if artifact_type == "result":
            context.log_result(key, obj.to_dict(orient="list"))
            return
        context.log_dataset(key, df=obj,
                            format=cfg.get("file_format", "parquet"))

    def unpack(self, data_item, hint):
        return data_item.as_df()


class PandasSeriesPackager(DefaultPackager):
    artifact_types = ("dataset", "result")
    default_artifact_type = "dataset"
    priority = 2

    def can_pack(self, obj):
        import pandas as pd

        return isinstance(obj, pd.Series)

    def can_unpack(self, hint):
        import pandas as pd

        return hint is pd.Series

    def pack(self, context, obj, key, artifact_type="", **cfg):
        if artifact_type == "result":
            context.log_result(key, obj.tolist())
            return
        context.log_dataset(key, df=obj.to_frame(),
                            format=cfg.get("file_format", "parquet"))

    def unpack(self, data_item, hint):
        return data_item.as_df().iloc[:, 0]
