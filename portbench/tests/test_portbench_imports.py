"""Nothing the harness runs imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from pbcore import cells, guard

SOURCES = sorted(p for p in cells.BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_by_whole_top_level_name():
    assert guard.forbidden_modules(["mogp_tpu_torch", "mogp_tpu_torch.ops", "jaxtyping",
                                    "numpy"]) == []
    assert guard.forbidden_modules(["mogp_tpu", "mogp_tpu.ops", "jax.numpy", "jaxlib",
                                    "flax.linen"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                                       "mogp_tpu", "mogp_tpu.ops"]


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    found = [(p.name, m) for p in SOURCES for m in _imports(p)
             if guard.forbidden_modules([m])]
    assert found == []


@pytest.mark.parametrize("kind", ["reference", "generators"])
def test_reference_imports_nothing_of_the_program(kind):
    # nor does a data generator: the benchmark makes the inputs itself
    paths = list((cells.BENCH / kind).rglob("*.py"))
    assert paths
    for p in paths:
        assert not [m for m in _imports(p) if m.split(".")[0] in ("mogp_tpu_torch", "pbcore")]


def test_a_run_loads_no_jax():
    # every module of the harness, and the program, in a fresh interpreter
    code = ("import sys; sys.path[:0] = [{root!r}, {bench!r}]\n"
            "import mogp_tpu_torch\n"
            "from pbcore import cells, cli, faults, worker\n"
            "from reference import gp_ref\n"
            "for w in ('tsunami64.fit', 'large_n4096.fit'):\n"
            "    c = cells.load(w).config; cells.generator(c); cells.reference(c)\n"
            "from pbcore import guard\n"
            "print(guard.forbidden_modules())\n").format(root=str(cells.ROOT),
                                                           bench=str(cells.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    # the CPU sandbox has no card: the run exits with 3 and prints nothing
    p = subprocess.run([sys.executable, str(cells.BENCH / "run.py"), "--workload",
                        "tsunami64.fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=str(cells.ROOT))
    assert p.returncode == 3 and p.stdout == ""


def test_run_without_the_program_fails(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tsunami64.fit",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
    assert Path(tmp_path / "portbench").is_dir()
