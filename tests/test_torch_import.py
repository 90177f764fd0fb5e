"""The PyTorch port never imports JAX, nor any module of the JAX package
`geneevolve_tpu`: importing the package, its CLI, its engines, its host
modules and its kernel wrappers (and `chip_smoke.py`, `kernel_ab.py`) in a
fresh interpreter leaves `jax` and `geneevolve_tpu` out of `sys.modules`,
and no source file of the port names `geneevolve_tpu` in an import."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "geneevolve_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("module", [
    "geneevolve_tpu_torch",
    "geneevolve_tpu_torch.cli",
    "geneevolve_tpu_torch.config",
    "geneevolve_tpu_torch.core.engine",
    "geneevolve_tpu_torch.core.checkpoint",
    "geneevolve_tpu_torch.core.convert",
    "geneevolve_tpu_torch.core.output",
    "geneevolve_tpu_torch.core.mating",
    "geneevolve_tpu_torch.io",
    "geneevolve_tpu_torch.native",
    "geneevolve_tpu_torch.ops.materialize",
    "geneevolve_tpu_torch.ops.meiose_merge",
    "geneevolve_tpu_torch.ops.meiose_packed",
    "geneevolve_tpu_torch.ops.meiose_planes",
    "geneevolve_tpu_torch.ops.paint",
    "geneevolve_tpu_torch.utils.telemetry",
    "geneevolve_tpu_torch.dense.step",
    "geneevolve_tpu_torch.dense.packed",
    "geneevolve_tpu_torch.dense.backend",
    "geneevolve_tpu_torch.dense.scenario",
    "geneevolve_tpu_torch.dense.streamed",
    "geneevolve_tpu_torch.parallel.mating_device",
    "chip_smoke",
    "kernel_ab",
])
def test_import_leaves_jax_out(module):
    code = (
        f"import sys, importlib; importlib.import_module({module!r}); "
        "bad = [m for m in sys.modules if any("
        f"m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "geneevolve_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py", REPO / "kernel_ab.py"]
)


@pytest.mark.parametrize("path", SOURCES)
def test_sources_never_import_jax_package(path):
    bad = [n for n in _imported_names(REPO / path) if _forbidden(n)]
    assert not bad, (path, bad)


def test_scan_covers_every_package():
    """The scan reaches every subpackage of the port, `parallel/` too."""
    for path in ("geneevolve_tpu_torch/parallel/__init__.py",
                 "geneevolve_tpu_torch/parallel/mating_device.py",
                 "geneevolve_tpu_torch/dense/scenario.py",
                 "geneevolve_tpu_torch/dense/streamed.py"):
        assert path in SOURCES, path


def test_chip_smoke_refuses_without_cuda():
    """`chip_smoke.py` fails, printing no result, where CUDA is absent."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_ab_refuses_without_cuda():
    """`kernel_ab.py` fails where CUDA is absent, printing no timing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(REPO / "kernel_ab.py"), "--one",
                          str(REPO)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ms"' not in res.stdout
