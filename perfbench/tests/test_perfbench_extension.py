"""A cell, a configuration, a traffic mix and a per-layer metric are
added by dropping files in and adding entries to BENCHMARK.json: the
harness lists and resolves them with no code edited."""

import json
import shutil

import cells
from conftest import BENCH, ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "perfbench"
    config = json.loads((new / "configs" / "mistral-7b.json").read_text())
    config.update(name="mistral-7b-wide", num_hidden_layers=8,
                  reduced=["num_hidden_layers"])
    (new / "configs" / "mistral-7b-wide.json").write_text(json.dumps(config))
    mix = json.loads((new / "traffic" / "chat-prefix.json").read_text())
    mix.update(request_rate_per_s=1.5,
               system_prompts=dict(mix["system_prompts"], count=8))
    (new / "traffic" / "chat-slow.json").write_text(json.dumps(mix))
    (new / "metrics" / "prefill_share.slow.py").write_text(
        '"""Share of the window\'s requests that are first turns."""\n\n\n'
        "def read(run):\n"
        "    due = [r for r in run['requests'] if r['in_window']]\n"
        "    return sum(r['req'].index == 0 for r in due) / len(due) "
        "if due else None\n")
    bench["configs"].append({
        "name": "mistral-7b-wide", "source": "https://example.org/c",
        "file": "perfbench/configs/mistral-7b-wide.json",
        "reduced": ["num_hidden_layers"], "why": "an added configuration"})
    bench["workloads"].append({
        "name": "mistral-7b-wide.chat-slow", "config": "mistral-7b-wide",
        "traffic": "chat-slow", "chips": 1, "why": "an added cell"})
    bench["end_to_end"].append({
        "name": "ttft_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
        "source": "host_clock", "workloads": ["mistral-7b-wide.chat-slow"]})
    bench["per_layer"].append({
        "name": "prefill_share.slow", "unit": "share", "better": "higher",
        "source": "host_clock", "layer": "load generator",
        "moves": "ttft_p95_ms", "workloads": ["mistral-7b-wide.chat-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.resolve("mistral-7b-wide.chat-slow", root=tmp_path)
    assert cell.config["num_hidden_layers"] == 8
    assert cell.traffic["system_prompts"]["count"] == 8
    assert [m["name"] for m in cell.per_layer] == ["prefill_share.slow"]
    assert "ttft_p95_ms" in [m["name"] for m in cell.end_to_end]
    run = {"requests": [
        {"in_window": True, "req": type("R", (), {"index": 0})()},
        {"in_window": True, "req": type("R", (), {"index": 2})()}]}
    assert cells.read_metrics(cell.per_layer, run, tmp_path) == {
        "prefill_share.slow": {"value": 0.5, "unit": "share"}}
    # the existing cell resolves as before
    assert cells.resolve("mixtral-8x7b.train-8k", root=tmp_path).config[
        "num_hidden_layers"] == 2


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = cells.load_benchmark()
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.load_reader(metric["name"]))
    for workload in bench["workloads"]:
        cell = cells.resolve(workload["name"])
        assert cell.traffic["kind"] in ("chat_sessions", "closed_batch",
                                        "packed_documents")
    # the serving cells kept for later resolve from their files
    for config, mix in (("mistral-7b", "chat-prefix"),
                        ("mistral-7b", "batch-decode")):
        assert cells.from_files(config, mix).config["num_hidden_layers"] == 32
