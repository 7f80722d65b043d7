"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
program."""
import ast
import os
import subprocess
import sys

from wavebench import harness

ROOT = harness.ROOT
WB = os.path.join(ROOT, "wavebench")


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_harness_and_every_module_it_names_load_no_jax():
    code = """
import json, os, sys
from wavebench import harness, calibrate, inputs, tracing, compare
import pdwt_tpu_torch, pdwt_tpu_torch.kernels
for w in harness.load_json("BENCHMARK.json")["workloads"]:
    spec = harness.Spec(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in spec.metrics(kind):
            harness.load_module(os.path.join(spec.dir, "metrics", m["name"] + ".py"), "m_" + m["name"])
print(json.dumps([harness.banned_modules(), "pdwt_tpu_torch" in sys.modules]))
"""
    assert _run(code) == '[[], true]'


def test_reference_imports_nothing_of_the_program():
    code = """
import json, sys
from wavebench.reference import transforms
from wavebench import compare, inputs
from wavebench.work import filterbank
from wavebench.traffic import roundtrip, ti_step
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules} & {"pdwt_tpu_torch", "pdwt_tpu", "jax"})))
"""
    assert _run(code) == "[]"
    for folder in ("reference", "work"):
        for name in os.listdir(os.path.join(WB, folder)):
            if name.endswith(".py"):
                with open(os.path.join(WB, folder, name)) as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                            [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    assert not any(m.split(".")[0].startswith("pdwt_tpu") for m in mods), name


def test_banned_names_compare_whole(monkeypatch):
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "pdwt_tpu_torch_fake", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "pdwt_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["jax", "pdwt_tpu"]
