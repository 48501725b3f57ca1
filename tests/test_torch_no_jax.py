"""The port stands alone: no JAX, explicit devices, no TF32."""

import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch import config  # noqa: E402

PKG = pathlib.Path(mogp_tpu_torch.__file__).resolve().parent

_FRESH_IMPORT = """
import sys, torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
import mogp_tpu_torch
assert 'jax' not in sys.modules, 'importing mogp_tpu_torch imported jax'
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
"""


def test_fresh_import_loads_no_jax_and_switches_tf32_off():
    """In a fresh interpreter: importing the port pulls in no JAX and sets
    the precision policy even when TF32 was switched on before."""
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH_IMPORT],
        cwd=str(PKG.parent), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_file_of_the_port_imports_jax():
    """Every module of the package, its tools included, and chip_smoke.py
    (which may import the package) import neither JAX nor mogp_tpu."""
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) >= 10
    assert any(p.parent.name == "tools" for p in files) and files[-1].is_file()
    assert {"uq", "compat.py", "meanfunction.py", "formula.py", "misc.py"} <= (
        {p.parent.name for p in files} | {p.name for p in files})
    walked = {p.relative_to(PKG).as_posix() for p in files[:-1]}
    assert {"ops/hmc.py", "models/inference.py", "uq/smc.py", "uq/sequential_design.py",
            "uq/mice_device.py", "uq/dimension_reduction.py", "parallel/mesh.py",
            "parallel/sharded.py"} <= walked
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "mogp_tpu"), (path, name)


def test_tf32_stays_off():
    """Precision guard: TF32 keeps 10 mantissa bits, the hazard that bf16
    passes were on the TPU for the kernel matrix and the mean algebra."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        config.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        config.default_dtype("cuda:0")
    with pytest.raises(RuntimeError):
        mogp_tpu_torch.GaussianProcess([[0.0], [1.0]], [0.0, 1.0], device="cuda")


def test_default_dtype_follows_device(monkeypatch):
    """The default device is the card, decided when called, never at import."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.default_dtype("cpu") == torch.float64
    assert config.default_dtype(None) == torch.float32
    assert config.resolve_device(None) == torch.device("cuda")
