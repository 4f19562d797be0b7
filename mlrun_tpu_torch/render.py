"""Notebook / HTML rendering of runs and artifacts — the port's copy
of ``mlrun_tpu/render.py``: a run table, an artifact table and a run's
detail card (``RunObject.show`` / ``_repr_html_``), shown through
IPython where it is installed."""

from __future__ import annotations

import html

_style = """
<style>
.mlt-table { border-collapse: collapse; font-family: monospace; }
.mlt-table th, .mlt-table td {
  border: 1px solid #ccc; padding: 4px 8px; text-align: left; }
.mlt-table th { background: #f0f0f0; }
.mlt-state-completed { color: #0a7d00; }
.mlt-state-error { color: #c00000; }
.mlt-state-running { color: #0050c0; }
</style>
"""


def _cell(value) -> str:
    if value is None:
        return ""
    if isinstance(value, dict):
        return html.escape(", ".join(
            f"{k}={_round(v)}" for k, v in value.items()))
    return html.escape(str(value))


def _round(value):
    if isinstance(value, float):
        return round(value, 4)
    return value


def runs_to_html(runs: list[dict], display: bool = True) -> str:
    """Render a run list to an HTML table."""
    headers = ["uid", "name", "state", "start", "results", "artifacts"]
    rows = []
    for run in runs:
        meta = run.get("metadata", {})
        status = run.get("status", {})
        state = status.get("state", "")
        # states are free-form strings from the DB — never interpolate raw
        state_class = _state_class(state)
        rows.append(
            "<tr>"
            f"<td>{_cell((meta.get('uid') or '')[:12])}</td>"
            f"<td>{_cell(meta.get('name'))}</td>"
            f"<td class='mlt-state-{state_class}'>{_cell(state)}</td>"
            f"<td>{_cell(str(status.get('start_time', ''))[:19])}</td>"
            f"<td>{_cell(status.get('results'))}</td>"
            f"<td>{_cell(list((status.get('artifact_uris') or {})))}</td>"
            "</tr>")
    table = (
        _style + "<table class='mlt-table'><tr>"
        + "".join(f"<th>{h}</th>" for h in headers) + "</tr>"
        + "".join(rows) + "</table>")
    if display:
        _display_html(table)
    return table


def artifacts_to_html(artifacts: list[dict], display: bool = True) -> str:
    headers = ["key", "kind", "tag", "size", "target"]
    rows = []
    for artifact in artifacts:
        meta = artifact.get("metadata", {})
        spec = artifact.get("spec", {})
        rows.append(
            "<tr>"
            f"<td>{_cell(meta.get('key'))}</td>"
            f"<td>{_cell(artifact.get('kind'))}</td>"
            f"<td>{_cell(meta.get('tag'))}</td>"
            f"<td>{_cell(spec.get('size'))}</td>"
            f"<td>{_cell(spec.get('target_path'))}</td>"
            "</tr>")
    table = (
        _style + "<table class='mlt-table'><tr>"
        + "".join(f"<th>{h}</th>" for h in headers) + "</tr>"
        + "".join(rows) + "</table>")
    if display:
        _display_html(table)
    return table


def run_to_html(run: dict, display: bool = True) -> str:
    """A run's detail card: identity, labels / parameters / results
    tables, artifact links, inline iframes for html plot artifacts."""
    meta = run.get("metadata", {})
    spec = run.get("spec", {})
    status = run.get("status", {})
    sections = [_style, "<div class='mlt-run'>"]
    state = status.get("state", "")
    sections.append(
        f"<h3 class='mlt-run-title'>{_cell(meta.get('name'))} "
        f"<span class='mlt-state-{_state_class(state)}'>"
        f"[{_cell(state)}]</span></h3>")
    identity = {
        "uid": meta.get("uid", ""),
        "project": meta.get("project", ""),
        "iteration": meta.get("iteration", 0),
        "start": str(status.get("start_time", ""))[:19],
        "last update": str(status.get("last_update", ""))[:19],
    }
    sections.append(_kv_table(identity))
    for title, mapping in (("labels", meta.get("labels")),
                           ("parameters", spec.get("parameters")),
                           ("results", status.get("results"))):
        if mapping:
            sections.append(f"<h4>{title}</h4>")
            sections.append(_kv_table(mapping))
    error = status.get("error")
    if error:
        sections.append(
            f"<p class='mlt-state-error'>error: {_cell(error)}</p>")
    uris = status.get("artifact_uris") or {}
    if uris:
        sections.append("<h4>artifacts</h4><ul>")
        for key, uri in uris.items():
            sections.append(
                f"<li><a href='{html.escape(str(uri), quote=True)}'>"
                f"{_cell(key)}</a></li>")
        sections.append("</ul>")
    for artifact in status.get("artifacts") or []:
        frame = artifact_to_iframe(artifact)
        if frame:
            sections.append(frame)
    sections.append("</div>")
    content = "".join(sections)
    if display:
        if not _display_html(content):
            return ""
    return content


def artifact_to_iframe(artifact: dict, height: int = 500) -> str:
    """Inline iframe for plot / html artifacts; empty string for
    non-visual kinds."""
    spec = artifact.get("spec", {})
    meta = artifact.get("metadata", {})
    viewer = spec.get("viewer", "")
    fmt = (spec.get("format") or "").lower()
    target = spec.get("target_path", "") or ""
    is_html = viewer == "web-app" or fmt == "html" \
        or target.endswith(".html")
    if not is_html:
        return ""
    body = None
    if target:
        try:
            from .datastore import store_manager

            body = store_manager.object(url=target).get()
        except Exception:  # noqa: BLE001 - unreadable target: no preview
            return ""
    if body is None:
        return ""
    if isinstance(body, bytes):
        body = body.decode(errors="replace")
    return (f"<h4>{_cell(meta.get('key'))}</h4>"
            f"<iframe srcdoc=\"{html.escape(body, quote=True)}\" "
            f"width='100%' height='{int(height)}' frameborder='0'>"
            "</iframe>")


def _kv_table(mapping: dict) -> str:
    rows = "".join(
        f"<tr><th>{_cell(k)}</th><td>{_cell(_round(v))}</td></tr>"
        for k, v in mapping.items())
    return f"<table class='mlt-table'>{rows}</table>"


def _state_class(state) -> str:
    import re

    return re.sub(r"[^a-z0-9-]", "", str(state).lower())[:32]


def _display_html(content: str) -> bool:
    try:
        from IPython.display import HTML, display as ipy_display

        ipy_display(HTML(content))
        return True
    except ImportError:
        return False
