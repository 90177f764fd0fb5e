import os

# Tests run on the CPU backend with 8 virtual devices so sharding tests work
# anywhere. The environment may pin an experimental platform via
# JAX_PLATFORMS (and merges rather than honors overrides), so force it
# through the config API before any backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_EXAMPLES_ZIP = Path("/root/reference/Examples.zip")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (the port's kernels); skips "
        "elsewhere",
    )


@pytest.fixture(scope="session")
def examples_dir(tmp_path_factory) -> Path:
    """The reference Examples.zip inputs (read-only fixture data)."""
    if not _EXAMPLES_ZIP.exists():
        pytest.skip("reference Examples.zip not available")
    root = tmp_path_factory.mktemp("examples")
    with zipfile.ZipFile(_EXAMPLES_ZIP) as z:
        z.extractall(root)
    return root / "Examples"


import numpy as np


@pytest.fixture(scope="session")
def mini_scenario(tmp_path_factory):
    """50 founders, 2 chromosomes x 200 SNPs, 4 generations, 1 phenotype."""
    root = tmp_path_factory.mktemp("mini")
    rng = np.random.default_rng(42)
    n0, nsnp, ncv = 50, 200, 10
    chrs = [1, 2]
    hap_rows, cv_rows = [], []
    for c in chrs:
        hap = rng.integers(0, 2, size=(nsnp, 2 * n0))
        np.savetxt(root / f"ref.chr{c}.hap", hap, fmt="%d")
        pos = np.sort(rng.choice(np.arange(1_000_000, 50_000_000), nsnp, False))
        with open(root / f"ref.chr{c}.legend", "w") as f:
            f.write("id position a0 a1\n")
            for i, p in enumerate(pos):
                f.write(f"rs{c}_{i} {p} A G\n")
        with open(root / f"ref.chr{c}.indv", "w") as f:
            f.writelines(f"{i + 1}\n" for i in range(n0))
        cv_cols = np.sort(rng.choice(nsnp, ncv, replace=False))
        np.savetxt(root / f"cv.chr{c}.hap", hap[cv_cols], fmt="%d")
        for i in cv_cols:
            cv_rows.append((c, pos[i], rng.normal(), 0.0))
        hap_rows.append(c)
    with open(root / "cv.info", "w") as f:
        f.write("chr pos a d\n")
        for c, p, a, d in cv_rows:
            f.write(f"{c} {p} {a} {d}\n")
    with open(root / "hap_address.txt", "w") as f:
        f.write("chr hap legend sample\n")
        for c in chrs:
            f.write(
                f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
                f"{root}/ref.chr{c}.indv\n"
            )
    with open(root / "cv_address.txt", "w") as f:
        for c in chrs:
            f.write(f"{c} {root}/cv.chr{c}.hap\n")
    with open(root / "popinfo.txt", "w") as f:
        f.write(
            "pop_size mat_cor offspring_dist selection_func "
            "selection_func_par1 selection_func_par2\n"
        )
        for _ in range(4):
            f.write("60 0.2 p thr 1 1\n")
    with open(root / "rmap.txt", "w") as f:
        f.write("chr bp cM\n")
        for c in chrs:
            for bp in range(0, 60_000_000, 50_000):
                f.write(f"{c} {bp} {bp / 1_000_000:.6f}\n")
    return root
