"""Processes, nodes and ranks of the port (`parallel/multihost.py`,
`parallel/launch.py`; mirrors `tests/test_multihost.py`): one process is
rank 0 of 1 on one node; a (4, 2) mesh's row ranges; two gloo ranks posing
as two nodes get `.host0`/`.host1` and their rows, and sum across both;
two ranks of one node carry no suffix; `maybe_init_distributed` joins a
group from torchrun's or the JAX module's environment spellings; a rank
that raises fails the whole launch with its traceback, and ranks that hang
fail it at its deadline."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import torch_dist
from geneevolve_tpu_torch.parallel import launch, multihost

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
DEADLINE_S = 120  # each launch of ranks
NODE_ENV = ("GROUP_RANK", "LOCAL_WORLD_SIZE", "WORLD_SIZE", "RANK",
            "MASTER_ADDR", "GE_COORDINATOR_ADDRESS")


@pytest.fixture
def clean_env(monkeypatch):
    for k in NODE_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_single_process(clean_env):
    assert multihost.process_info() == (0, 1)
    assert multihost.host_suffix() == ""
    assert multihost.is_node_writer()
    assert multihost.maybe_init_distributed("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


def test_host_row_ranges_4x2(clean_env):
    # one node holds every row, merged into one range
    assert multihost.host_row_ranges(64, (4, 2)) == [(0, 64)]
    # the second of four nodes of 2 ranks: ind coordinate 1
    clean_env.setenv("GROUP_RANK", "1")
    clean_env.setenv("LOCAL_WORLD_SIZE", "2")
    assert multihost.host_row_ranges(64, (4, 2)) == [(16, 32)]
    # an uneven split: blocks of ceil(n / ind) rows, the last one short
    assert multihost.host_row_ranges(61, (4, 2)) == [(16, 32)]
    clean_env.setenv("GROUP_RANK", "3")
    assert multihost.host_row_ranges(61, (4, 2)) == [(48, 61)]


def test_two_nodes_of_one_rank(clean_env):
    n = 32
    res = torch_dist.launch_by(time.monotonic() + DEADLINE_S,
                               torch_dist.two_nodes, 2, (n,))
    for k, r in enumerate(res):
        assert r["suffix"] == f".host{k}"
        assert r["rows"] == [(k * n // 2, (k + 1) * n // 2)]
        assert r["total"] == n * (n - 1) // 2
        assert r["info"] == (k, 2)
        assert r["writer"]


def test_one_node_two_ranks_no_suffix(clean_env):
    res = torch_dist.launch_by(time.monotonic() + DEADLINE_S,
                               torch_dist.one_node, 2)
    assert [r["suffix"] for r in res] == ["", ""]
    assert [r["info"] for r in res] == [(0, 2), (1, 2)]
    assert [r["writer"] for r in res] == [True, False]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("spelling", ["torchrun", "ge"])
def test_maybe_init_distributed_joins(clean_env, spelling):
    """A one-process group from either spelling; a second call is a
    no-op."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in NODE_ENV}
    if spelling == "torchrun":
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="1", RANK="0")
    else:
        env.update(GE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   GE_NUM_PROCESSES="1", GE_PROCESS_ID="0")
    code = ("import torch.distributed as d; "
            "from geneevolve_tpu_torch.parallel import multihost as m; "
            "a = m.maybe_init_distributed('cpu'); "
            "b = m.maybe_init_distributed('cpu'); "
            "print(a, b, d.is_initialized(), d.get_backend()); "
            "d.destroy_process_group()")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(0,", "1)", "(0,", "1)", "True", "gloo"]


def test_failing_rank_fails_the_launch(clean_env):
    """Rank 1 raises while rank 0 waits in a collective: the launch raises
    rank 1's traceback well inside the group timeout, and no rank is
    left running."""
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="injected failure on rank 1"):
        torch_dist.launch_by(time.monotonic() + DEADLINE_S,
                             torch_dist.fail_on_rank1, 2)
    assert time.monotonic() - t0 < 60


def test_hanging_ranks_fail_at_the_deadline(clean_env):
    """Ranks that never finish fail the launch at its deadline, and none
    is left running."""
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="did not finish"):
        torch_dist.launch_by(time.monotonic() + 10, torch_dist.hang, 2)
    assert time.monotonic() - t0 < 40


def test_once_shares_a_failure(tmp_path_factory):
    """`once` pickles a failure: later calls raise it without running the
    function again."""
    calls = []

    def fail():
        calls.append(1)
        raise ValueError("injected")

    with pytest.raises(ValueError, match="injected"):
        torch_dist.once(tmp_path_factory, "once_failure", fail)
    with pytest.raises(RuntimeError, match="ValueError: injected"):
        torch_dist.once(tmp_path_factory, "once_failure", fail)
    assert calls == [1]
