"""What a run may load and where it may run: top-level module names are
compared whole, the benchmark's own sources import neither JAX nor the JAX
package nor (the reference) the program, and a run fails, printing no
result, without a card or without the program beside it."""

import ast
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rt_torch_probe", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "rtx", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    for name in ("rt", "rt.scene", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["flax", "jax", "jaxlib", "rt"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(root, sub=""):
    top = os.path.join(root, "benchmark", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_import_no_jax_and_the_reference_not_the_program(root):
    for path in _sources(root):
        assert not {"jax", "jaxlib", "flax", "rt"} & set(_imports(path)), path
    for path in _sources(root, "reference"):
        assert "rt_torch" not in set(_imports(path)), path


def test_sources_read_no_old_bench_files(root):
    old = ("bench.py", "bench_configs", "BENCH_", "TPUCHECK_", "MULTICHIP_")
    for path in _sources(root):
        if os.sep + "tests" + os.sep in path:
            continue
        text = open(path).read()
        assert not any(o in text for o in old), path


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "suzanne-720p-spp128", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_no_result_beside_only_the_benchmark(root, tmp_path):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "rtiow3-800x450-converge", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_no_program_no_result_on_the_card(root, tmp_path, cuda):
    test_no_result_beside_only_the_benchmark(root, tmp_path)
