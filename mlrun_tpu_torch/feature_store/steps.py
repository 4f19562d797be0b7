"""Feature-set transform steps + aggregations — the port's copy of
``mlrun_tpu/feature_store/steps.py`` (the pandas engine).

A feature set may declare a transform graph (map/filter/one-hot/imputer) and
windowed aggregations; ``apply_transforms``/``apply_aggregations`` run them
during ingest.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import pandas as pd

from ..utils import logger


class MapValues:
    """Map column values through a dict with optional default
    (reference steps.py MapValues).

    NOTE all step classes keep attribute names == __init__ parameter names:
    serialization stores vars(step) as class_args and reconstructs by
    calling __init__ with them (see step_to_dict).
    """

    def __init__(self, mapping: dict, with_original_features: bool = True,
                 suffix: str = "_mapped"):
        self.mapping = mapping
        self.with_original_features = with_original_features
        self.suffix = suffix

    def do(self, df: pd.DataFrame) -> pd.DataFrame:
        for column, column_map in self.mapping.items():
            if column not in df.columns:
                continue
            default = column_map.get("default")
            target = (f"{column}{self.suffix}"
                      if self.with_original_features else column)
            df[target] = df[column].map(
                {k: v for k, v in column_map.items() if k != "default"})
            if default is not None:
                df[target] = df[target].fillna(default)
        return df


class Imputer:
    """Fill missing values by method or constant (reference steps.py Imputer)."""

    def __init__(self, method: str = "avg", default_value=None,
                 mapping: dict | None = None):
        self.method = method
        self.default_value = default_value
        self.mapping = mapping or {}

    def do(self, df: pd.DataFrame) -> pd.DataFrame:
        for column in df.columns:
            if not df[column].isna().any():
                continue
            value = self.mapping.get(column, self.default_value)
            if value is None and df[column].dtype.kind in "if":
                if self.method == "avg":
                    value = df[column].mean()
                elif self.method == "median":
                    value = df[column].median()
                elif self.method == "mode":
                    modes = df[column].mode()
                    value = modes.iloc[0] if len(modes) else None
            if value is not None and pd.isna(value):
                value = None  # all-NaN column: nothing to impute from
            if value is not None:
                df[column] = df[column].fillna(value)
        return df


class OneHotEncoder:
    """Expand categorical columns (reference steps.py OneHotEncoder)."""

    def __init__(self, mapping: dict):
        self.mapping = mapping  # column -> list of categories

    def do(self, df: pd.DataFrame) -> pd.DataFrame:
        for column, categories in self.mapping.items():
            if column not in df.columns:
                continue
            for category in categories:
                df[f"{column}_{category}"] = (
                    df[column] == category).astype(int)
            df = df.drop(columns=[column])
        return df


class DropFeatures:
    def __init__(self, features: list):
        self.features = features

    def do(self, df: pd.DataFrame) -> pd.DataFrame:
        return df.drop(columns=[c for c in self.features if c in df.columns])


class FilterRows:
    """Keep rows matching a pandas query expression."""

    def __init__(self, query: str):
        self.query = query

    def do(self, df: pd.DataFrame) -> pd.DataFrame:
        return df.query(self.query)


class FeaturesetValidator:
    """Value-range validation; violations are logged (and optionally raise)."""

    def __init__(self, checks: dict | None = None, raise_on_fail: bool = False):
        # checks: column -> {min, max}
        self.checks = checks or {}
        self.raise_on_fail = raise_on_fail

    def do(self, df: pd.DataFrame) -> pd.DataFrame:
        for column, bounds in self.checks.items():
            if column not in df.columns:
                continue
            bad = pd.Series(False, index=df.index)
            if "min" in bounds:
                bad |= df[column] < bounds["min"]
            if "max" in bounds:
                bad |= df[column] > bounds["max"]
            count = int(bad.sum())
            if count:
                message = (f"validation failed: {count} rows of "
                           f"'{column}' outside {bounds}")
                if self.raise_on_fail:
                    raise ValueError(message)
                logger.warning(message)
        return df


_step_classes = {
    "MapValues": MapValues,
    "Imputer": Imputer,
    "OneHotEncoder": OneHotEncoder,
    "DropFeatures": DropFeatures,
    "FilterRows": FilterRows,
    "FeaturesetValidator": FeaturesetValidator,
}


def step_to_dict(step) -> dict:
    """Serializable form {class_name, class_args}. Step classes keep
    attribute names == __init__ parameter names to make this lossless."""
    if isinstance(step, dict):
        return step
    return {"class_name": type(step).__name__,
            "class_args": {k: v for k, v in vars(step).items()
                           if not k.startswith("_")}}


def resolve_step(step):
    if hasattr(step, "do"):
        return step
    if isinstance(step, dict):
        cls = _step_classes.get(step.get("class_name"))
        if cls is None:
            raise ValueError(f"unknown transform step {step}")
        return cls(**step.get("class_args", {}))
    raise ValueError(f"unsupported transform step {step!r}")


def apply_transforms(df: pd.DataFrame, steps: list) -> pd.DataFrame:
    for step in steps or []:
        df = resolve_step(step).do(df)
    return df


_AGG_FUNCS = {
    "sum": "sum", "avg": "mean", "mean": "mean", "min": "min", "max": "max",
    "count": "count", "std": "std", "var": "var", "last": "last",
    "first": "first",
}


def apply_aggregations(df: pd.DataFrame, aggregations: list,
                       entities: list[str], timestamp_key: str | None
                       ) -> pd.DataFrame:
    """Windowed aggregations (reference FeatureSet.add_aggregation):
    each spec {name, column, operations, windows} adds
    ``<name>_<op>_<window>`` columns — a rolling time window per entity when
    a timestamp is set, else a full-history aggregate per entity.
    """
    if not aggregations:
        return df
    if timestamp_key and timestamp_key in df.columns:
        df = df.sort_values(timestamp_key)
    for spec in aggregations:
        name = spec.get("name") or spec["column"]
        column = spec["column"]
        operations = spec.get("operations", ["avg"])
        windows = spec.get("windows", ["1h"]) or [None]
        if column not in df.columns:
            logger.warning("aggregation column missing", column=column)
            continue
        for window in windows:
            for op in operations:
                func = _AGG_FUNCS.get(op)
                if func is None:
                    raise ValueError(f"unsupported aggregation op '{op}'")
                out = f"{name}_{op}_{window}" if window else f"{name}_{op}"
                if timestamp_key and window and timestamp_key in df.columns:
                    def rolling(group):
                        g = group.set_index(timestamp_key)[column]
                        r = getattr(g.rolling(window), func)()
                        r.index = group.index  # align to original rows
                        return r

                    if entities:
                        # manual group loop: groupby.apply can unstack a
                        # returned Series into a frame for single groups
                        parts = [rolling(group) for _, group
                                 in df.groupby(entities)]
                        values = pd.concat(parts)
                    else:
                        values = rolling(df)
                    df[out] = values  # index-aligned assignment
                else:
                    if entities:
                        df[out] = df.groupby(entities)[column].transform(func)
                    else:
                        df[out] = getattr(df[column], func)()
    return df
