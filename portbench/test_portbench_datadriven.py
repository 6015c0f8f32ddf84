"""The harness finds a cell, a configuration, a traffic mix and a metric
by their names alone, and ``BENCHMARK.json`` keeps to its contract's
forms."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    spec = _spec()
    conf = json.loads((HERE / "configs" / "phi4-mini-3.8b.json").read_text())
    conf["name"] = "phi4-mini-3.8b-copy"
    (bench / "configs" / "phi4-mini-3.8b-copy.json").write_text(
        json.dumps(conf))
    mix = json.loads((HERE / "traffic" / "chat.json").read_text())
    mix["prompt"]["max"] = 64
    (bench / "traffic" / "chat-short.json").write_text(json.dumps(mix))
    (bench / "metrics" / "quanta_seen.py").write_text(
        "def read(obs, trace):\n    return float(len(obs['window_plans']))\n")
    spec["configs"].append(dict(spec["configs"][0], name="phi4-mini-3.8b-copy",
                                file="portbench/configs/phi4-mini-3.8b-copy.json"))
    spec["workloads"].append({"name": "phi4-copy-short",
                              "config": "phi4-mini-3.8b-copy",
                              "traffic": "chat-short", "chips": 1,
                              "why": "a cell added as data"})
    spec["end_to_end"][0]["workloads"].append("phi4-copy-short")
    spec["per_layer"].append({"name": "quanta_seen", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "serve_tok_s",
                              "workloads": ["phi4-copy-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json\n"
        "from portbench import harness, tiny\n"
        "spec = harness.load_spec()\n"
        "cell, conf, mix = harness.cell_inputs(spec, 'phi4-copy-short')\n"
        "print(conf['name'], mix['prompt']['max'], harness.runner(mix).__name__,"
        " harness.reader('quanta_seen').__module__)\n"
        "line, _ = tiny.run('phi4-copy-short', trace=True)\n"
        "print(json.dumps(sorted(line['metrics'])))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    found, metrics = out.stdout.strip().splitlines()[-2:]
    assert found == ("phi4-mini-3.8b-copy 64 "
                     "portbench.runners.serve_closed "
                     "portbench.metrics.quanta_seen")
    assert "quanta_seen" in json.loads(metrics)
    after = _digests(bench)
    assert {k: after[k] for k in before} == before


def test_benchmark_json_keeps_to_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][0] == "python3"
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in spec["paths"] + spec["command"][1:])
    assert 1 <= spec["run_seconds"] <= 51
    assert 338 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = {}
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in spec[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200
            names.setdefault(group, set()).add(e["name"])
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names["workloads"]
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["config"] in names["configs"]
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert NAME.match(w["traffic"])
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        rep = [m for m in metrics
               if w["name"] in m.get("workloads", [w["name"]])]
        assert sum(m in spec["end_to_end"] for m in rep) >= 2
        assert any(m in spec["per_layer"] for m in rep)
    assert len(json.dumps(spec)) <= 64 * 1024


def test_a_configuration_file_holds_what_it_runs():
    """phi4-mini-3.8b's file holds the published numbers that the model
    runs with, and names every key it changed from its source in
    ``reduced``, as ``BENCHMARK.json`` does."""
    conf = json.loads((HERE / "configs" / "phi4-mini-3.8b.json").read_text())
    entry = next(c for c in _spec()["configs"]
                 if c["name"] == "phi4-mini-3.8b")
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])
    assert all(k in conf for k in conf["reduced"])
    a = conf["arch"]
    assert (conf["num_hidden_layers"], conf["hidden_size"],
            conf["num_attention_heads"], conf["num_key_value_heads"],
            conf["hidden_size"] // conf["num_attention_heads"],
            conf["intermediate_size"], conf["vocab_size"],
            conf["tie_word_embeddings"], conf["rope_theta"],
            conf["rms_norm_eps"]) == (
        a["n_layers"], a["d_model"], a["n_heads"], a["n_kv_heads"],
        a["head_dim"], a["d_ff"], a["vocab_size"], a["tie_embeddings"],
        a["rope_theta"], a["norm_eps"])
