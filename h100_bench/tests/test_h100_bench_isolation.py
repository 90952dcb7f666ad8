"""Nothing the harness imports is JAX or the JAX package (`repro`), the
references import nothing of the port either, and the command refuses
to run without a card or outside a checkout.  Module names are compared
by their top-level part, whole: `repro_torch` begins with `repro`."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from h100_bench.tests import tiny
from h100_bench import bench

ROOT = tiny.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOAD_ALL = """
import importlib, importlib.util, json, pathlib, sys
sys.path[:0] = [{src!r}, {root!r}]
for name in ("bench", "calibrate", "check", "model", "run", "trace",
             "traffic", "weights", "window", "yardstick", "families"):
    importlib.import_module("h100_bench." + name)
for sub in ("families", "reference"):
    for path in sorted(pathlib.Path({here!r}, sub).glob("*.py")):
        importlib.import_module(f"h100_bench.{{sub}}.{{path.stem}}")
for path in sorted(pathlib.Path({here!r}, "metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import importlib, json, pathlib, sys
sys.path[:0] = [{root!r}]
for path in sorted(pathlib.Path({here!r}, "reference").glob("*.py")):
    importlib.import_module("h100_bench.reference." + path.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(LOAD_ALL.format(src=str(ROOT / "src"),
                                       root=str(ROOT), here=str(tiny.HERE)))
    assert "repro_torch" in names and "h100_bench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = _top_level(LOAD_REFERENCE.format(root=str(ROOT),
                                             here=str(tiny.HERE)))
    assert not names & (FORBIDDEN | {"repro_torch"}), names


def test_jax_loaded_compares_whole_names():
    assert bench.jax_loaded({"repro_torch": 0, "repro_torch.serve": 0,
                             "reproduce": 0, "jax_free": 0}) == []
    assert bench.jax_loaded({"repro.serve": 0, "jaxlib.xla": 0,
                             "flax": 0, "repro_torch": 0}) == \
        ["flax", "jaxlib", "repro"]


def test_command_refuses_without_a_card(monkeypatch, capsys):
    from h100_bench import run

    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "TORCHINDUCTOR_CACHE_DIR"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", "internlm2-20b.code", "--seed",
                   str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_command_refuses_outside_a_checkout(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark's
    own files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "internlm2-20b.code", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
