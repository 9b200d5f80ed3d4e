"""``BENCHMARK.json`` against the files it names and the contract's
rules on names, units and metrics; what the harness may import; the
weights' digest; ``run.py`` without a card."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT

HERE = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]+$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    for dirpath, dirs, files in os.walk(HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH_CHARS.match(rel), rel


def test_entries_resolve_to_their_files():
    b = bench()
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert load("configs", c["name"] + ".json")["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = load("workloads", w["name"] + ".json")
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".py"))
        assert cell["config"] in {c["name"] for c in b["configs"]}
        assert set(cell["params"]["limits"]) and all(
            v is not None for v in cell["params"]["limits"].values())
    from portbench import run
    for m in b["per_layer"]:
        path = run.reader_path(m["name"])
        assert path, m["name"]
        with open(path) as f:
            assert "def read(trace, ctx)" in f.read(), m["name"]


def test_names_units_and_keys():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("host_clock", "device_trace",
                               "program_span", "program_counter")
        if m["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_layer_metric_moves_what_its_cells_report():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]

    def reports(cell, metric):
        return "workloads" not in metric or cell in metric["workloads"]

    by_name = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in by_name
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(cell, by_name[m["moves"]]), (m["name"], cell)
    for cell in cells:
        e2e = [m["name"] for m in b["end_to_end"] if reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reports(cell, m) for m in b["per_layer"]), cell


def test_weights_match_their_digest():
    for name in os.listdir(os.path.join(HERE, "configs")):
        weights = load("configs", name)["weights"]
        if "file" in weights:
            with open(os.path.join(HERE, weights["file"]), "rb") as f:
                assert hashlib.sha256(f.read()).hexdigest() == \
                    weights["sha256"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    forbidden = {"jax", "jaxlib", "flax", "optax", "cnn_autoencoder_tpu"}
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            found = set(_imports(path))
            assert not found & forbidden, (path, found & forbidden)
            if os.sep + "reference" in path:
                assert "cnn_autoencoder_tpu_torch" not in found, path
            if os.sep + "tests" not in path:
                with open(path) as src:
                    assert "benchmarks/" not in src.read(), path


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "flagship.encode", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _run(ROOT, env)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_run_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""



def test_metrics_resolve_by_name_less_a_qualifier():
    from portbench import run
    have = {"train_img_per_s", "mfu.train"}.__contains__
    assert run.resolve("train_img_per_s.residual", have) == "train_img_per_s"
    assert run.resolve("mfu.train.residual", have) == "mfu.train"
    assert run.resolve("mfu.train", have) == "mfu.train"
    assert run.resolve("idle.encode", have) is None
    assert run.reader_path("idle.train.flagship").endswith(
        os.path.join("metrics", "idle.py"))
