"""What the harness and the references may import, checked on their
sources by whole top-level module names (``repro_torch`` is not
``repro``), and the runs that must print no result."""
import ast
import shutil
import subprocess
import sys

import small
from harness import cli

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NOT_FROM_THE_REPO = {"benchmarks", "chip_smoke", "scripts"}
CODE = [p for p in small.BENCH.rglob("*.py") if "tests" not in p.parts]


def imported(path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_imports(path) -> set:
    """Dotted ``harness`` modules ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module == "harness":
            out |= {f"harness.{a.name}" for a in node.names}
        elif isinstance(node, ast.ImportFrom) and \
                node.module.startswith("harness."):
            out.add(node.module)
    return out


def test_the_harness_imports_no_jax_and_nothing_of_the_reference_package():
    assert CODE
    for path in CODE:
        bad = imported(path) & (FORBIDDEN | NOT_FROM_THE_REPO)
        assert not bad, f"{path}: {sorted(bad)}"


def test_the_references_import_nothing_of_the_program():
    todo = list((small.BENCH / "reference").glob("*.py"))
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        assert "repro_torch" not in imported(path), path
        for mod in harness_imports(path):
            todo.append(small.BENCH / (mod.replace(".", "/") + ".py"))
    assert small.BENCH / "harness" / "chain.py" in seen


def test_whole_names_are_compared():
    assert "repro_torch" not in FORBIDDEN
    assert set(cli.FORBIDDEN) == FORBIDDEN
    sys.modules.setdefault("repro_torch_probe", sys)
    assert "repro_torch_probe" not in cli.loaded_forbidden()


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "deeprx-cluster8", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_a_run_without_a_card_prints_no_result():
    out = _run(small.BENCH.parent)
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_run_with_only_the_benchmarks_files_prints_no_result(tmp_path):
    shutil.copy(small.BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(small.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
