"""The manifest against the benchmark's contract, every cell's files found
by name, and the import rules (no JAX anywhere; the reference imports
nothing of the program)."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sigman_release_tpu"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
    for word in m["command"]:
        assert "\t" not in word and "\n" not in word and not word.startswith("/")
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for section, allowed in keys.items():
        for entry in m[section]:
            assert set(entry) == allowed, entry
            assert NAME.match(entry["name"])
    for entry in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    assert len({e["name"] for e in m["end_to_end"] + m["per_layer"]}) == \
        len(m["end_to_end"]) + len(m["per_layer"])
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0 < e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert e["moves"] in {x["name"] for x in m["end_to_end"]}
    for c in m["configs"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(json.dumps(m)) <= 64 * 1024


def test_every_cell_finds_its_files_by_name():
    sys.path.insert(0, ROOT)
    from portbench import run as R

    m = manifest()
    for w in m["workloads"]:
        files = R.cell_files(m, w["name"])
        conf_path = os.path.join(ROOT, files["config"]["file"])
        with open(conf_path) as f:
            conf = json.load(f)
        assert set(files["config"]["reduced"]) <= set(conf)
        traffic = os.path.join(ROOT, "portbench", "traffic",
                               f"{w['traffic']}.json")
        with open(traffic) as f:
            mode = json.load(f)["mode"]
        for path in (os.path.join(ROOT, "portbench", "drivers",
                                  f"{conf['family']}_{mode}.py"),
                     os.path.join(ROOT, "portbench", "limits",
                                  f"{w['name']}.json")):
            assert os.path.isfile(path), path
        assert files["end_to_end"] and files["per_layer"]
        assert any(e["name"] == "setup_s" for e in files["end_to_end"])
        for e in files["end_to_end"]:
            R.load_file(os.path.join(ROOT, "portbench", "endtoend",
                                     f"{e['name']}.py"), "e2e_" + e["name"])
        for e in files["per_layer"]:
            reader = R.load_file(os.path.join(ROOT, "portbench", "metrics",
                                              f"{e['name']}.py"),
                                 "metric_" + e["name"])
            assert callable(reader.read)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_and_the_reference_stands_alone():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
        if os.sep + "reference" + os.sep in path:
            assert "sigman_release_torch" not in tops, path


@pytest.mark.parametrize("package", ["portbench.reference", "portbench"])
def test_loaded_modules_hold_no_jax(package):
    """Every module under the package imported in a fresh process: no
    forbidden top-level module is loaded, and the reference loads nothing
    of the program."""
    mods = []
    for path in _sources("reference" if package.endswith("reference")
                         else ""):
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith("__init__"):
            rel = rel[:-9]
        if "tests" in rel.split(".") or "-" in rel or rel.count(".") and \
                rel.split(".")[1] in ("metrics", "endtoend"):
            continue
        mods.append(rel)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    if package.endswith("reference"):
        assert "sigman_release_torch" not in tops
