"""Plot, chart and table artifacts — the port's copy of
``mlrun_tpu/artifacts/plots.py``."""

from __future__ import annotations

import base64

from .base import Artifact


class PlotArtifact(Artifact):
    """A matplotlib-figure artifact rendered to an html <img> page."""

    kind = "plot"

    def __init__(self, key=None, body=None, title=None, **kwargs):
        super().__init__(key, body=body, format="html", **kwargs)
        self.kind = "plot"
        self.title = title

    def get_body(self):
        body = self._body
        if body is None:
            return None
        if hasattr(body, "savefig"):  # a figure or pyplot module
            from io import BytesIO

            buf = BytesIO()
            body.savefig(buf, format="png", bbox_inches="tight")
            data = base64.b64encode(buf.getvalue()).decode()
            title = self.title or self.key
            return (
                f"<html><head><title>{title}</title></head><body>"
                f"<h3>{title}</h3><img src=\"data:image/png;base64,{data}\">"
                "</body></html>"
            )
        return body


class ChartArtifact(Artifact):
    """Tabular chart artifact rendered with a simple html table fallback."""

    kind = "chart"

    def __init__(self, key=None, data=None, header=None, options=None, **kwargs):
        super().__init__(key, format="html", **kwargs)
        self.kind = "chart"
        self.header = header or []
        self.options = options or {}
        self._rows = []
        if data:
            for row in data:
                self.add_row(row)

    def add_row(self, row):
        self._rows.append(list(row))

    def get_body(self):
        rows = self._rows
        header = self.header or (rows[0] if rows else [])
        body_rows = rows if not self.header else rows
        head_html = "".join(f"<th>{h}</th>" for h in header)
        rows_html = "".join(
            "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
            for row in body_rows
        )
        return (
            f"<html><body><table border=1><tr>{head_html}</tr>{rows_html}"
            "</table></body></html>"
        )


class BokehArtifact(Artifact):
    kind = "bokeh"


class TableArtifact(Artifact):
    """CSV/table body artifact."""

    kind = "table"

    def __init__(self, key=None, body=None, df=None, viewer="table", **kwargs):
        if df is not None:
            body = df.to_csv(index=False)
            kwargs.setdefault("format", "csv")
        super().__init__(key, body=body, viewer=viewer, **kwargs)
        self.kind = "table"
