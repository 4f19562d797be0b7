"""mlrun_tpu_torch's alerts (service/alerts.py), notifications
(utils/notifications/) and ``SLOEvaluator.process`` against mlrun_tpu's:
the alert cases of tests/test_obs_control_plane.py (``process`` firing
through the silence window, the refire damper, empty trigger events, the
closed loop on fake engines), tests/test_monitoring.py's silence window
and tests/test_api_parity.py's templates, each run on both packages over
each package's own SQLite run db with the same inputs.

Every comparison is exact: the fired names, the stored alert configs
(``last_fired`` masked: a wall-clock time), the events (``created``
masked), the notification payloads each package sends to a local HTTP
server, and the JobFailed flow of a failing run.
"""

import http.server
import itertools
import json
import threading
import types
from datetime import datetime, timedelta, timezone

import pytest

from mlrun_tpu import obs as jobs
from mlrun_tpu.db import sqlitedb as jsqlite
from mlrun_tpu.serving import fleet as jfleet
from mlrun_tpu.service import alerts as jalerts
from mlrun_tpu.service import autoscaler as jautoscaler
from mlrun_tpu.utils.notifications import notification as jnotification
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.db import sqlitedb as tsqlite
from mlrun_tpu_torch.serving import fleet as tfleet
from mlrun_tpu_torch.service import alerts as talerts
from mlrun_tpu_torch.service import autoscaler as tautoscaler
from mlrun_tpu_torch.utils.notifications import notification as tnotification

from .test_obs_control_plane import _feed_histogram
from .test_torch_obs_control_plane import _live, _scalable_fleet, _scaler

PKGS = {
    "jax": types.SimpleNamespace(
        obs=jobs, db=jsqlite, alerts=jalerts, fleet=jfleet,
        autoscaler=jautoscaler, notification=jnotification),
    "port": types.SimpleNamespace(
        obs=tobs, db=tsqlite, alerts=talerts, fleet=tfleet,
        autoscaler=tautoscaler, notification=tnotification),
}


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.fleet, "_FLEET_SEQUENCE", itertools.count(1))
        pkg.obs.REGISTRY.reset()
    yield


def _alike(scenario, tmp_path):
    """``scenario(pkg, db)`` on both packages, each over its own fresh
    SQLite db: equal results, returned once."""
    got = {}
    for name, pkg in PKGS.items():
        db = pkg.db.SQLiteRunDB(str(tmp_path / f"{name}.db"),
                                logs_dir=str(tmp_path / f"{name}-logs"))
        got[name] = scenario(pkg, db)
    assert got["port"] == got["jax"]
    return got["port"]


def _configs(db, project="p1") -> list:
    return [{k: v for k, v in c.items() if k != "last_fired"}
            for c in db.list_alert_configs(project)]


def _events(db, project="p1", kind="") -> list:
    return [{k: v for k, v in e.items() if k != "created"}
            for e in db.list_events(project, kind=kind)]


# -- templates ----------------------------------------------------------------

def test_alert_templates_match_reference(tmp_path):
    """The builtin templates, a config made from one as a project makes
    it (name, entity, notifications) and stored, and the unknown-name
    error."""
    assert talerts.list_alert_templates() == jalerts.list_alert_templates()
    assert talerts.ALERT_TEMPLATES == jalerts.ALERT_TEMPLATES

    def from_template(pkg, db):
        config = pkg.alerts.get_alert_template("JobFailed")
        config.update(name="train-fail", entity_id="trainer",
                      notifications=[{"kind": "console"}])
        db.store_alert_config("train-fail", config, "p1")
        with pytest.raises(KeyError) as err:
            pkg.alerts.get_alert_template("nope")
        return db.get_alert_config("train-fail", "p1"), str(err.value)

    stored, error = _alike(from_template, tmp_path)
    assert stored["trigger_events"] == ["run_failed", "run_aborted"]
    assert stored["entity_id"] == "trainer"
    assert "unknown alert template" in error


@pytest.mark.parametrize("pkg", list(PKGS))
def test_alert_templates_are_isolated_copies(pkg):
    alerts = PKGS[pkg].alerts
    template = alerts.get_alert_template("JobFailed")
    template["trigger_events"].append("CORRUPTED")
    template["criteria"]["count"] = 99
    clean = alerts.ALERT_TEMPLATES["JobFailed"]
    assert "CORRUPTED" not in clean["trigger_events"]
    assert clean["criteria"]["count"] == 1


# -- process_event ------------------------------------------------------------

def _silence_window(pkg, db):
    config = {"name": "fail-alert", "project": "p1",
              "trigger_events": ["run_failed"],
              "criteria": {"count": 1, "period_seconds": 3600},
              "notifications": [{"kind": "console"}]}
    db.store_alert_config("fail-alert", config, "p1")
    fired = []
    db.emit_event("run_failed", {"entity_id": "job1"}, "p1")
    fired.append(pkg.alerts.process_event(db, "p1", "run_failed",
                                          {"entity_id": "job1"}))
    config = db.get_alert_config("fail-alert", "p1")
    config["state"] = "inactive"
    config["silence_until"] = (datetime.now(timezone.utc)
                               + timedelta(minutes=10)).isoformat()
    db.store_alert_config("fail-alert", config, "p1")
    db.emit_event("run_failed", {"entity_id": "job1"}, "p1")
    fired.append(pkg.alerts.process_event(db, "p1", "run_failed",
                                          {"entity_id": "job1"}))
    config = db.get_alert_config("fail-alert", "p1")
    config["silence_until"] = (datetime.now(timezone.utc)
                               - timedelta(seconds=1)).isoformat()
    db.store_alert_config("fail-alert", config, "p1")
    fired.append(pkg.alerts.process_event(db, "p1", "run_failed",
                                          {"entity_id": "job1"}))
    # another entity's event: the config names no entity ("*"), so it counts
    fired.append(pkg.alerts.process_event(db, "p1", "run_failed",
                                          {"entity_id": "job2"}))
    configs = _configs(db)
    for config in configs:
        config.pop("silence_until")
    return fired, configs, _events(db)


def test_alert_silence_window(tmp_path):
    """tests/test_monitoring.py's case on both packages: fires, stays
    silent inside the window (criteria still evaluated), fires again
    once it has passed."""
    fired, configs, events = _alike(_silence_window, tmp_path)
    assert fired == [["fail-alert"], [], ["fail-alert"], ["fail-alert"]]
    assert configs[0]["count"] == 3 and configs[0]["state"] == "active"
    assert len(events) == 2


def _empty_triggers(pkg, db):
    base = {"criteria": {"count": 1, "period_seconds": 3600},
            "notifications": [{"kind": "console"}]}
    db.store_alert_config("no-triggers", {
        "name": "no-triggers", "project": "p1", **base}, "p1")
    db.store_alert_config("empty-triggers", {
        "name": "empty-triggers", "project": "p1", "trigger_events": [],
        **base}, "p1")
    db.store_alert_config("catch-all", {
        "name": "catch-all", "project": "p1", "trigger_events": ["*"],
        **base}, "p1")
    fired = []
    for kind in ("run_failed", "anything_else"):
        db.emit_event(kind, {"entity_id": "job1"}, "p1")
        fired.append(pkg.alerts.process_event(db, "p1", kind,
                                              {"entity_id": "job1"}))
    return fired, _configs(db)


def test_alert_empty_trigger_events_matches_nothing(tmp_path):
    fired, _ = _alike(_empty_triggers, tmp_path)
    assert fired == [["catch-all"], ["catch-all"]]


# -- SLOEvaluator.process ----------------------------------------------------

def _slo_silence(pkg, db):
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    _feed_histogram(store, [(0, 100, 0, 10)])  # everything is slow
    slo = pkg.obs.SLO("ttft", "latency", target=0.25, q=0.95)
    ev = pkg.obs.SLOEvaluator(store, [slo], fast_window=10, slow_window=30,
                              fast_burn=1.0, slow_burn=1.0, project="p1")
    config = pkg.alerts.get_alert_template("SLOBurnRate")
    config["name"] = "ttft-burn"
    db.store_alert_config("ttft-burn", config, "p1")
    fired = [ev.process(db, at=99)]
    config = db.get_alert_config("ttft-burn", "p1")
    config["silence_until"] = (datetime.now(timezone.utc)
                               + timedelta(minutes=10)).isoformat()
    db.store_alert_config("ttft-burn", config, "p1")
    fired.append(ev.process(db, at=99))
    breaching = ev.status()[0].breaching
    config = db.get_alert_config("ttft-burn", "p1")
    config["silence_until"] = (datetime.now(timezone.utc)
                               - timedelta(minutes=1)).isoformat()
    db.store_alert_config("ttft-burn", config, "p1")
    fired.append(ev.process(db, at=99))
    events = _events(db, kind="slo_burn_rate")
    return fired, breaching, events, pkg.obs.REGISTRY.get(
        "mlt_slo_breaches_total").value(slo="ttft")


def test_slo_process_fires_alert_and_respects_silence(tmp_path):
    fired, breaching, events, breaches = _alike(_slo_silence, tmp_path)
    assert fired == [["ttft-burn"], [], ["ttft-burn"]]
    assert breaching and breaches == 3
    # every breach is persisted for count-over-period criteria, silenced
    # or not
    assert len(events) == 3 and events[-1]["slo"] == "ttft"


def _refire(pkg, db):
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    _feed_histogram(store, [(0, 200, 0, 10)])  # breaching throughout
    slo = pkg.obs.SLO("ttft", "latency", target=0.25, q=0.95)
    ev = pkg.obs.SLOEvaluator(store, [slo], fast_window=10, slow_window=30,
                              fast_burn=1.0, slow_burn=1.0,
                              refire_after=60.0, project="p1")
    config = pkg.alerts.get_alert_template("SLOBurnRate")
    config["name"] = "ttft-burn"
    db.store_alert_config("ttft-burn", config, "p1")
    fired = [ev.process(db, at=50), ev.process(db, at=65),
             ev.status()[0].breaching, ev.process(db, at=111)]
    healthy = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    _feed_histogram(healthy, [(0, 130, 10, 0)])
    ev.store = healthy
    fired.append(ev.process(db, at=120))
    ev.store = store
    fired.append(ev.process(db, at=125))
    return fired, _configs(db), len(_events(db, kind="slo_burn_rate"))


def test_slo_sustained_breach_refire_damping(tmp_path):
    fired, configs, events = _alike(_refire, tmp_path)
    assert fired == [["ttft-burn"], [], True, ["ttft-burn"], [],
                     ["ttft-burn"]]
    assert configs[0]["count"] == 3 and events == 3


def _closed_loop_alert(pkg, db):
    fleet, _ = _scalable_fleet(pkg)
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    slo = pkg.obs.SLO("ttft", "latency", target=0.1, q=0.95)
    evaluator = pkg.obs.SLOEvaluator(store, [slo], fast_window=5,
                                     slow_window=20, fast_burn=1.0,
                                     slow_burn=1.0, project="p1")
    config = pkg.alerts.get_alert_template("SLOBurnRate")
    config["name"] = "ttft-burn"
    db.store_alert_config("ttft-burn", config, "p1")
    scaler = _scaler(pkg, fleet, store=store, max_replicas=3,
                     ttft_p95_high_s=0.1, queue_high=4.0, queue_low=1.0,
                     ttft_window=5.0)
    offered = [12] * 30 + [0] * 6
    trajectory, fired_at = [], []
    cum = {"0.05": 0.0, "0.25": 0.0, "+Inf": 0.0}
    for t, load in enumerate(offered):
        live = _live(fleet)
        per_replica = load // len(live) if load else 0
        for replica in live:
            replica.engine.queue = per_replica
        good = per_replica <= 4
        cum["0.05"] += load if good else 0
        cum["0.25"] += load if good else 0
        cum["+Inf"] += load
        for le in ("0.05", "0.25", "+Inf"):
            store.record("mlt_llm_ttft_seconds_bucket", cum[le], at=t,
                         labels={"le": le}, kind="counter")
        store.record("mlt_llm_ttft_seconds_count", cum["+Inf"], at=t,
                     kind="counter")
        if evaluator.process(db, at=float(t)):
            fired_at.append(t)
        scaler.tick(now=float(t))
        trajectory.append(len(_live(fleet)))
    p95 = store.quantile("mlt_llm_ttft_seconds", 0.95, 5, len(offered) - 8)
    out = (trajectory, fired_at, p95, evaluator.status()[0].breaching,
           len(fleet.replicas), _configs(db))
    fleet.stop()
    return out


def test_closed_loop_ramp_scale_up_down_with_slo_alert(tmp_path):
    """The reference's acceptance loop on fake engines: the overload's
    burn fires SLOBurnRate through service/alerts, 3 replicas absorb the
    ramp, the windowed p95 falls back under target, the fleet drains to
    one replica."""
    trajectory, fired_at, p95, breaching, replicas, _ = _alike(
        _closed_loop_alert, tmp_path)
    assert fired_at and fired_at[0] <= 3
    assert max(trajectory) == 3 and trajectory[3] == 3
    assert p95 <= 0.1 and not breaching
    assert trajectory[-1] == 1 and replicas == 1


# -- a failing run fires JobFailed --------------------------------------------

def _job_failed(pkg, db):
    import mlrun_tpu
    import mlrun_tpu_torch

    top = mlrun_tpu if pkg is PKGS["jax"] else mlrun_tpu_torch
    top.db.set_run_db(db)

    def train(context, model: str = "tiny"):
        raise ValueError(f"unknown model preset '{model}'")

    try:
        run = top.new_function("train", kind="tpujob", project="p1").run(
            handler=train, params={"model": "nope"}, local=True)
    finally:
        top.db.set_run_db(None)
    config = pkg.alerts.get_alert_template("JobFailed")
    config.update(name="job-failed", entity_id="*",
                  notifications=[{"kind": "console"}])
    db.store_alert_config("job-failed", config, "p1")
    event = {"entity_id": run.metadata.name, "uid": run.metadata.uid,
             "error": run.status.error}
    db.emit_event("run_failed", event, "p1")
    fired = pkg.alerts.process_event(db, "p1", "run_failed", event)
    stored = db.read_run(run.metadata.uid, "p1")
    return (run.status.state, run.status.error, stored["status"]["state"],
            fired, [{k: v for k, v in e.items() if k not in ("created", "uid")}
                    for e in db.list_events("p1", kind="run_failed")],
            [(c["name"], c["count"], c["state"]) for c in _configs(db)])


def test_failing_tpujob_run_fires_job_failed_once(tmp_path, capsys):
    """The chip smoke's runs leg (b) on a tiny handler: the run ends in
    error with the reason, the service-side event goes into the db and
    JobFailed fires once through a console notification."""
    state, error, stored, fired, events, configs = _alike(_job_failed,
                                                          tmp_path)
    assert state == stored == "error"
    assert "unknown model preset 'nope'" in error
    assert fired == ["job-failed"] and configs == [("job-failed", 1,
                                                    "active")]
    assert len(events) == 1
    assert capsys.readouterr().out.count("alert 'job-failed' fired") == 2


# -- notifications ------------------------------------------------------------

class _Recorder(http.server.BaseHTTPRequestHandler):
    """Records every request's method, path, JSON body and chosen headers."""

    def _record(self):
        length = int(self.headers.get("Content-Length") or 0)
        self.server.requests.append({
            "method": self.command, "path": self.path,
            "body": json.loads(self.rfile.read(length) or b"null"),
            "headers": {k: self.headers.get(k) for k in (
                "Content-Type", "X-Token", "Authorization", "PRIVATE-TOKEN")
                if self.headers.get(k) is not None}})
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    do_POST = do_PUT = _record

    def log_message(self, *args):
        pass


@pytest.fixture()
def http_sink():
    server = http.server.HTTPServer(("127.0.0.1", 0), _Recorder)
    server.requests = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()


def test_webhook_and_slack_payloads_match_reference(http_sink):
    url = f"http://127.0.0.1:{http_sink.server_port}"
    runs = [{"metadata": {"project": "p1", "name": "train"},
             "status": {"state": "error", "results": {"loss": 1.5}}}]
    got = {}
    for name, pkg in PKGS.items():
        http_sink.requests.clear()
        kinds = pkg.notification.notification_types
        kinds["webhook"]("w", {"url": f"{url}/hook", "method": "put",
                               "headers": {"X-Token": "t"}}).push(
            "run finished", "error", runs)
        kinds["slack"]("s", {"webhook": f"{url}/slack"}).push(
            "run finished", "info", runs)
        with pytest.raises(ValueError, match="'url'"):
            kinds["webhook"]("w", {}).push("m")
        got[name] = list(http_sink.requests)
    assert got["port"] == got["jax"]
    assert [r["method"] for r in got["port"]] == ["PUT", "POST"]
    assert got["port"][0]["body"]["runs"] == runs


def test_alert_notifies_a_webhook(http_sink, tmp_path):
    """process_event's fan-out to a webhook notification: the same POST
    from both packages."""
    url = f"http://127.0.0.1:{http_sink.server_port}/alerts"

    def fire(pkg, db):
        http_sink.requests.clear()
        config = pkg.alerts.get_alert_template("JobFailed")
        config.update(name="hook", summary="train failed",
                      notifications=[{"kind": "webhook",
                                      "params": {"url": url}}])
        db.store_alert_config("hook", config, "p1")
        db.emit_event("run_failed", {"entity_id": "train"}, "p1")
        fired = pkg.alerts.process_event(db, "p1", "run_failed",
                                         {"entity_id": "train"})
        return fired, list(http_sink.requests)

    fired, requests = _alike(fire, tmp_path)
    assert fired == ["hook"]
    assert requests[0]["body"]["message"] == \
        "alert 'hook' fired: train failed"


def test_git_mail_and_ipython_keep_reference_payloads(monkeypatch, capsys):
    """The git comment (GitHub, GitHub Enterprise, GitLab), the mail and
    the IPython markdown each package builds, recorded where it would
    leave the process (no network)."""
    import smtplib

    import requests

    sent = []

    class _Response:
        def raise_for_status(self):
            pass

    def record_post(url, json=None, headers=None, timeout=None):
        sent.append({"url": url, "body": json, "headers": headers})
        return _Response()

    def record_http(method, url, payload, headers=None):
        sent.append({"url": url, "body": payload, "headers": headers})
        return _Response()

    class _SMTP:
        def __init__(self, host, port, timeout=None):
            self.where = (host, port)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def send_message(self, msg):
            sent.append({"smtp": self.where, "message": {
                k: msg[k] for k in ("Subject", "From", "To")},
                "content": msg.get_content()})

    monkeypatch.setattr(requests, "post", record_post)
    monkeypatch.setattr(tnotification, "_http", record_http)
    monkeypatch.setattr(smtplib, "SMTP", _SMTP)
    runs = [{"metadata": {"project": "p1", "name": "train"},
             "status": {"state": "completed", "results": {"loss": 0.5}}}]
    got = {}
    for name, pkg in PKGS.items():
        sent.clear()
        kinds = pkg.notification.notification_types
        for params in ({"repo": "o/r", "issue": 3, "token": "tk"},
                       {"repo": "o/r", "issue": 3, "token": "tk",
                        "server": "git.corp", "provider": "github"},
                       {"repo": "g/p", "issue": 5, "token": "tk",
                        "server": "gitlab.com"}):
            kinds["git"]("g", params).push("done", "info", runs)
        with pytest.raises(ValueError, match="explicit provider"):
            kinds["git"]("g", {"repo": "o/r", "issue": 1, "token": "t",
                               "server": "git.corp"}).push("m")
        kinds["mail"]("m", {"to": "a@b", "server_port": 2525}).push(
            "done", "info", runs)
        kinds["ipython"]("i").push("done", "info")
        got[name] = (list(sent), capsys.readouterr().out)
    assert got["port"] == got["jax"]
    urls = [s.get("url") for s in got["port"][0]]
    assert urls[:3] == [
        "https://api.github.com/repos/o/r/issues/3/comments",
        "https://git.corp/api/v3/repos/o/r/issues/3/comments",
        "https://gitlab.com/api/v4/projects/g%2Fp/issues/5/notes"]
    assert got["port"][0][3]["message"]["Subject"] == \
        "[mlrun-tpu][info] done"
