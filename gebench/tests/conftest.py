"""Fixtures of the benchmark's tests: a tiny cell written into a temporary
checkout layout, and the card's presence, decided in a fixture."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

TINY = dict(pop_size=60, founders=40, chromosomes=3, cvs_per_chromosome=6)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips elsewhere")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs only on the card")
    return "cuda"


def tiny_root(root: Path, generations: int = 3) -> Path:
    """A checkout layout under `root` whose BENCHMARK.json holds the cells
    `tiny.rand` and `tiny.admix`: the repository's configuration and mixes
    at a few dozen individuals, 3 chromosomes and 3 generations."""
    (root / "gebench" / "configs").mkdir(parents=True)
    (root / "gebench" / "mixes").mkdir()
    cfg = json.loads((REPO / "gebench/configs/t31_30k.json").read_text())
    cfg.update(name="tiny", **TINY)
    (root / "gebench/configs/tiny.json").write_text(json.dumps(cfg))
    for m in ("rand", "admix"):
        mix = json.loads((REPO / f"gebench/mixes/{m}.json").read_text())
        mix["generations"] = generations
        (root / f"gebench/mixes/{m}.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="gebench/configs/tiny.json")]
    bench["workloads"] = [
        dict(w, config="tiny", name=w["name"].replace("t31_30k", "tiny"))
        for w in bench["workloads"] if w["config"] == "t31_30k"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny(tmp_path):
    import torch

    torch.set_num_threads(1)
    return tiny_root(tmp_path / "checkout")
