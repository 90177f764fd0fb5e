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
# the dense configuration at a few hundred rows: three chromosomes of uneven
# panels, so that two are padded, and CVs on panel sites
TINY_DENSE = dict(pop_size=300, founders=20, chromosomes=3,
                  cvs_per_chromosome=6, snps_per_chromosome=[70, 45, 100],
                  snps=215, mutation_rate_per_bin=1.0)

# the growth configuration at a few dozen to a few hundred individuals:
# unequal founders, and rates at which each generation outgrows its parents'
# planes (a resize every generation, as at full size); the migration rate
# moves a few individuals each way
TINY_GROW = dict(pop_size=[360, 300], founders=[24, 17],
                 growth_per_generation=[1.1, 1.0], chromosomes=3,
                 cvs_per_chromosome=6)
TINY_GROW_MIGRATION = [[0.94, 0.06], [0.05, 0.95]]


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
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w.replace("t31_30k", "tiny")
                              for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny(tmp_path):
    import torch

    torch.set_num_threads(1)
    return tiny_root(tmp_path / "checkout")


def tiny_dense_root(root: Path, generations: int = 3) -> Path:
    """A checkout layout under `root` whose BENCHMARK.json holds the cell
    `tinyd.rand`: the dense configuration at a few hundred individuals, 3
    chromosomes of uneven panels and 3 generations."""
    (root / "gebench" / "configs").mkdir(parents=True)
    (root / "gebench" / "mixes").mkdir()
    cfg = json.loads((REPO / "gebench/configs/dense31.json").read_text())
    cfg.update(name="tinyd", **TINY_DENSE)
    (root / "gebench/configs/tinyd.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "gebench/mixes/rand.json").read_text())
    mix["generations"] = generations
    (root / "gebench/mixes/rand.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(c, name="tinyd", file="gebench/configs/tinyd.json")
                        for c in bench["configs"] if c["name"] == "dense31"]
    bench["workloads"] = [dict(w, config="tinyd", name="tinyd.rand")
                          for w in bench["workloads"]
                          if w["name"] == "dense31.rand"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tinyd.rand" if w == "dense31.rand" else w
                              for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_dense(tmp_path):
    import torch

    torch.set_num_threads(1)
    return tiny_dense_root(tmp_path / "checkout")


def tiny_grow_root(root: Path, generations: int = 3) -> Path:
    """A checkout layout under `root` whose BENCHMARK.json holds the cell
    `tinyg.grow`: the growth configuration at a few dozen individuals, 3
    chromosomes and 3 generations."""
    (root / "gebench" / "configs").mkdir(parents=True)
    (root / "gebench" / "mixes").mkdir()
    cfg = json.loads((REPO / "gebench/configs/ooa2t12.json").read_text())
    cfg.update(name="tinyg", **TINY_GROW)
    (root / "gebench/configs/tinyg.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "gebench/mixes/grow.json").read_text())
    mix.update(generations=generations, migration=TINY_GROW_MIGRATION)
    (root / "gebench/mixes/grow.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        dict(c, name="tinyg", file="gebench/configs/tinyg.json")
        for c in bench["configs"] if c["name"] == "ooa2t12"]
    bench["workloads"] = [dict(w, config="tinyg", name="tinyg.grow")
                          for w in bench["workloads"]
                          if w["name"] == "ooa2t12.grow"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tinyg.grow" if w == "ooa2t12.grow" else w
                              for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_grow(tmp_path):
    import torch

    torch.set_num_threads(1)
    return tiny_grow_root(tmp_path / "checkout")
