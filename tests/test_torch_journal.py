"""mlrun_tpu_torch's intent journal (common/journal.py) against
mlrun_tpu's: the reference's journal cases (tests/test_control_recovery.py
:57-165) on both packages — the round trip and compaction, compaction
through the snapshot callable, a torn tail dropped and mid-file garbage
skipped, ``journal.write`` faults (a torn write, a failed write) that
never reach the caller, and ``open_journal`` gated on the config — with
the same files byte for byte; then the cross replay: a pod fleet of one
package writes the journal and crashes, a pod fleet of the other reads it
and reconciles into the same actions, both ways round.
"""

import itertools
import os

import pytest

from mlrun_tpu import chaos as jchaos
from mlrun_tpu.common import journal as jjournal
from mlrun_tpu.config import mlconf
from mlrun_tpu.serving import fleet as jfleet
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import config as tconfig
from mlrun_tpu_torch.common import journal as tjournal
from mlrun_tpu_torch.serving import fleet as tfleet

from .test_torch_podfleet import (
    PKGS,
    _cluster,
    _fleet,
    _flight,
    _journal_ops,
    _pods,
    _reset,
)

JOURNALS = {"jax": (jjournal, jchaos), "port": (tjournal, tchaos)}


@pytest.fixture(autouse=True)
def _fresh_state():
    _reset()
    yield
    _reset()


def _bytes(path) -> bytes:
    with open(path, "rb") as fp:
        return fp.read()


def _roundtrip(journal_mod, chaos, path):
    journal = journal_mod.IntentJournal(path, fsync_every=2)
    out = [journal.replay()]
    journal.append("pod", op="scale_up", pod="p1", rid=None)
    journal.append("pod", op="joined", pod="p1", rid="f1-u1")
    journal.append("pod", op="scale_up", pod="p2", rid=None)
    records = journal.replay()
    out.append(records)
    written = _bytes(path)
    latest = {r["pod"]: r for r in records}
    journal.compact([latest["p1"]])
    out.append((journal.replay(), journal.stats["compactions"]))
    out.append((journal.append("pod", op="bad", obj=object()),
                journal.stats["write_failures"]))
    journal.close()
    return out, written, _bytes(path)


def test_journal_roundtrip_and_compaction_like_reference(tmp_path):
    got = {name: _roundtrip(*mods, str(tmp_path / f"{name}.jsonl"))
           for name, mods in JOURNALS.items()}
    assert got["port"] == got["jax"]
    out, written, compacted = got["port"]
    assert out[0] == [] and [r["op"] for r in out[1]] == [
        "scale_up", "joined", "scale_up"]
    assert out[2] == ([out[1][1]], 1) and out[3] == (False, 1)
    assert written.count(b"\n") == 3 and compacted.count(b"\n") == 1


def _auto_compaction(journal_mod, chaos, path):
    snap = [{"kind": "pod", "op": "joined", "pod": "p1"}]
    journal = journal_mod.IntentJournal(path, compact_threshold=4,
                                        snapshot=lambda: snap)
    for i in range(9):
        journal.append("pod", op="scale_up", pod="p1", seq=i)
    out = (journal.stats["compactions"], journal.replay(), _bytes(path))
    journal.close()
    return out


def test_journal_auto_compaction_via_snapshot_like_reference(tmp_path):
    got = {name: _auto_compaction(*mods, str(tmp_path / f"{name}.jsonl"))
           for name, mods in JOURNALS.items()}
    assert got["port"] == got["jax"]
    compactions, records, _ = got["port"]
    assert compactions == 2 and len(records) <= 5


def _torn(journal_mod, chaos, path):
    journal = journal_mod.IntentJournal(path)
    journal.append("pod", op="scale_up", pod="p1")
    journal.append("pod", op="joined", pod="p1")
    journal.close()
    with open(path, "a", encoding="utf-8") as fp:
        fp.write('{"kind":"pod","op":"dra')
    recovered = journal_mod.IntentJournal(path)
    out = [([r["op"] for r in recovered.replay()], dict(recovered.stats))]
    # appending after a torn tail heals it first: the new record lands on
    # its own line and replays
    recovered.append("pod", op="delete", pod="p1")
    out.append(([r["op"] for r in recovered.replay()], _bytes(path)))
    recovered.close()
    lines = open(path, encoding="utf-8").readlines()
    lines[1] = "NOT JSON AT ALL\n"
    open(path, "w", encoding="utf-8").writelines(lines)
    recovered = journal_mod.IntentJournal(path)
    out.append(([r["op"] for r in recovered.replay()], dict(recovered.stats)))
    return out


def test_journal_torn_tail_dropped_mid_file_skipped_like_reference(tmp_path):
    got = {name: _torn(*mods, str(tmp_path / f"{name}.jsonl"))
           for name, mods in JOURNALS.items()}
    assert got["port"] == got["jax"]
    (ops, stats), (healed, _), (skipped, stats2) = got["port"]
    assert ops == ["scale_up", "joined"] and stats["torn_tail_dropped"] == 1
    assert stats["corrupt_skipped"] == 0
    assert healed == ["scale_up", "joined", "delete"]
    assert skipped == ["scale_up", "delete"]
    assert stats2["corrupt_skipped"] == 2


def _write_faults(journal_mod, chaos, path):
    journal = journal_mod.IntentJournal(path)

    def tear(point, ctx):
        ctx["box"]["line"] = ctx["box"]["line"][:7]

    journal.append("pod", op="scale_up", pod="p1")
    with chaos.chaos.inject(chaos.FaultPoints.journal_write,
                            chaos.fail_first(1), action=tear):
        torn_ok = journal.append("pod", op="drain", pod="p1")
    journal.close()
    recovered = journal_mod.IntentJournal(path)
    out = [torn_ok, [r["op"] for r in recovered.replay()],
           recovered.stats["torn_tail_dropped"]]
    with chaos.chaos.inject(chaos.FaultPoints.journal_write, chaos.always(),
                            error=OSError("disk gone")):
        out.append(recovered.append("pod", op="delete", pod="p1"))
    out += [recovered.stats["write_failures"],
            recovered.append("pod", op="delete", pod="p1"),
            recovered.replay()[-1]["op"]]
    recovered.close()
    return out, _bytes(path)


@pytest.mark.chaos
def test_journal_write_chaos_torn_and_failed_like_reference(tmp_path):
    """Each package's own ``journal.write`` point tears a line or fails a
    write; neither reaches the caller, and the files agree byte for
    byte."""
    got = {name: _write_faults(*mods, str(tmp_path / f"{name}.jsonl"))
           for name, mods in JOURNALS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == [True, ["scale_up"], 1, False, 1, True,
                              "delete"]


def test_open_journal_gated_on_config_like_reference(tmp_path, monkeypatch):
    """Off by default in both packages; on under ``journal_dir`` (the
    port's ``SERVING_FLEET_DEFAULTS``, the reference's mlconf), the same
    ``<dir>/<name>.jsonl``."""
    assert tjournal.open_journal("podfleet") is None
    assert jjournal.open_journal("podfleet") is None
    monkeypatch.setitem(tconfig.SERVING_FLEET_DEFAULTS, "journal_dir",
                        str(tmp_path / "port"))
    mlconf.serving.fleet.journal_dir = str(tmp_path / "jax")
    try:
        paths = []
        for module in (jjournal, tjournal):
            journal = module.open_journal("podfleet")
            journal.append("pod", op="scale_up", pod="p1")
            journal.close()
            paths.append(journal.path)
    finally:
        mlconf.serving.fleet.journal_dir = ""
    assert [os.path.relpath(p, tmp_path) for p in paths] == [
        os.path.join("jax", "podfleet.jsonl"),
        os.path.join("port", "podfleet.jsonl")]
    assert _bytes(paths[0]) == _bytes(paths[1])


# -- cross replay: one package writes, the other reconciles ------------------

def _write_then_crash(pkg, monkeypatch, cluster, provider, path, drill):
    """Leave ``cluster`` and ``path`` as a crashed controller of ``pkg``
    leaves them: mid scale-up, mid drain, or an interrupted delete, with a
    second pod joined beside it."""
    fleet, factory, _ = _fleet(pkg, replicas=1)
    pods = _pods(pkg, fleet, provider, factory,
                 journal=pkg.journal.IntentJournal(path))
    kept = pods.scale_up("unified")
    for _ in range(3):
        pods.tick()
    pod = pods.scale_up("unified")
    if drill != "mid_scale_up":
        for _ in range(3):
            pods.tick()
        rid = next(rec["rid"] for name, rec in pods._pods.items()
                   if name == pod)
        pods.drain(rid)
    if drill == "mid_delete":
        fleet.remove_replica(rid)
        with jchaos.chaos.inject("k8s.delete", jchaos.always(),
                                 error=RuntimeError("apiserver down")):
            pods.on_replica_removed(rid)
    pkg.podfleet.controller_crash(drill=drill)
    pods._journal.close()
    fleet.stop()
    return kept, pod


def _replay(writer, reader, monkeypatch, tmp_path, drill):
    for module in (jfleet, tfleet):
        monkeypatch.setattr(module, "_FLEET_SEQUENCE", itertools.count(1))
    _reset()
    wpkg, rpkg = PKGS[writer], PKGS[reader]
    cluster, _ = _cluster(wpkg, monkeypatch)
    path = str(tmp_path / f"{writer}-{reader}-{drill}.jsonl")
    kept, pod = _write_then_crash(wpkg, monkeypatch, cluster,
                                  wpkg.provider(namespace="testns"), path,
                                  drill)
    written = _journal_ops(path)
    # the restarted process starts with fresh telemetry, and its fleet is
    # the second one either way
    _reset()
    for module in (jfleet, tfleet):
        monkeypatch.setattr(module, "_FLEET_SEQUENCE", itertools.count(2))
    fleet, factory, _ = _fleet(rpkg, replicas=1)
    pods = _pods(rpkg, fleet, rpkg.provider(namespace="testns"), factory,
                 journal=rpkg.journal.IntentJournal(path))
    adopted = pods.pods()
    pods.tick()
    out = (written, adopted, pods.pods(), sorted(cluster.jobsets),
           _journal_ops(path), _flight(rpkg, ("reconcile.",)), kept, pod)
    fleet.stop()
    return out


@pytest.mark.chaos
@pytest.mark.parametrize("drill", ["mid_scale_up", "mid_drain", "mid_delete"])
def test_journal_cross_replay_reconciles_alike(monkeypatch, tmp_path, drill):
    """A journal the reference's pod fleet wrote is replayed by the port's
    ``reconcile`` into the same adopt / resume / orphan actions, phases,
    compacted journal and cluster as the reference's own restart — and a
    journal the port wrote, by the reference."""
    got = {(w, r): _replay(w, r, monkeypatch, tmp_path, drill)
           for w in PKGS for r in PKGS}
    first = got[("jax", "jax")]
    for key, value in got.items():
        assert value == first, key
    written, adopted, ticked, jobsets, compacted, flight, kept, pod = first
    assert {r["pod"] for r in written} == {kept, pod}
    assert adopted[kept] == "ready" and ticked[kept] == "joined"
    actions = [e["kind"] for e in flight]
    if drill == "mid_scale_up":
        assert adopted[pod] == "ready" and len(jobsets) == 2
        assert actions.count("reconcile.adopt") == 2
    elif drill == "mid_drain":
        assert adopted[pod] == "draining" and len(jobsets) == 2
        assert "reconcile.resume" in actions
    else:
        assert pod not in adopted and len(jobsets) == 1
        assert "reconcile.orphan" in actions
    assert {r["pod"] for r in compacted} == set(adopted)
