"""The PyTorch port never imports JAX: importing the package, its CLI, its
engines and its kernel wrappers in a fresh interpreter leaves `jax` out of
`sys.modules`."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", [
    "geneevolve_tpu_torch",
    "geneevolve_tpu_torch.cli",
    "geneevolve_tpu_torch.core.engine",
    "geneevolve_tpu_torch.core.convert",
    "geneevolve_tpu_torch.ops.meiose_merge",
    "geneevolve_tpu_torch.ops.meiose_packed",
    "geneevolve_tpu_torch.ops.meiose_planes",
    "geneevolve_tpu_torch.dense.step",
    "geneevolve_tpu_torch.dense.packed",
    "geneevolve_tpu_torch.dense.backend",
])
def test_import_leaves_jax_out(module):
    code = (
        f"import sys, importlib; importlib.import_module({module!r}); "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_without_cuda():
    """`chip_smoke.py` fails, printing no result, where CUDA is absent."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
