"""The PyTorch port's multi-process runtime (``parallel/distributed.py``)
and the CLI's process-group join.

The fast tests mirror the JAX package's ``tests/test_distributed.py``: the
HOCR_DIST_* contract, letter for letter, and the single-process no-op.
Then two processes run the port's CLI ``main([folder, "--backend",
"dryrun"])`` under HOCR_DIST_* over one output folder of three pages:
``main`` joins the gloo group, rank r takes pages r, r+2, ..., every page
is written exactly once, and every artifact equals a solo run's; over a
folder of one page, rank 1 owns none and still returns. The same
processes then run the multi-process helpers: ``global_mesh``,
``shard_host_batch`` (a rank is asked only for its own rows) and
``replicate_params`` (each keeps its tensor-parallel slices).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.cli import transcribe
from test_torch_cli import _artifacts, _page
from torch_port_dist import Group, cli_and_helpers

WORLD = 2
PAGES = ("b.png", "a.png", "c.png")


def test_initialize_noop_without_env(monkeypatch):
    from handwritten_ocr_tpu_torch.parallel import distributed

    for var in ("HOCR_DIST_COORD", "HOCR_DIST_NPROCS", "HOCR_DIST_PROC_ID",
                "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.distributed_env() is None
    assert distributed.initialize_from_env() is False
    assert distributed.initialize_from_env(auto=True) is False
    assert distributed.is_coordinator()          # solo process acts as rank 0


def test_distributed_env_parses(monkeypatch):
    from handwritten_ocr_tpu_torch.parallel import distributed

    monkeypatch.setenv("HOCR_DIST_COORD", "10.0.0.1:1234")
    monkeypatch.setenv("HOCR_DIST_NPROCS", "4")
    monkeypatch.setenv("HOCR_DIST_PROC_ID", "2")
    env = distributed.distributed_env()
    assert env == {"coordinator_address": "10.0.0.1:1234",
                   "num_processes": 4, "process_id": 2}
    # A 1-process "job" is solo.
    monkeypatch.setenv("HOCR_DIST_NPROCS", "1")
    assert distributed.distributed_env() is None


def test_distributed_env_requires_the_process_id(monkeypatch):
    """A job of two or more processes without HOCR_DIST_PROC_ID raises,
    naming the variable, where two such processes would both take rank 0
    and both serve the rendezvous store. The JAX package keeps the
    default of 0 (``handwritten_ocr_tpu/parallel/distributed.py:50``);
    the port departs from it here. A solo job still needs no rank."""
    from handwritten_ocr_tpu_torch.parallel import distributed

    monkeypatch.setenv("HOCR_DIST_COORD", "10.0.0.1:1234")
    monkeypatch.delenv("HOCR_DIST_PROC_ID", raising=False)
    for nprocs in ("2", "4"):
        monkeypatch.setenv("HOCR_DIST_NPROCS", nprocs)
        with pytest.raises(ValueError, match="HOCR_DIST_PROC_ID"):
            distributed.distributed_env()
        with pytest.raises(ValueError, match="HOCR_DIST_PROC_ID"):
            distributed.initialize_from_env()
    monkeypatch.setenv("HOCR_DIST_NPROCS", "1")
    assert distributed.distributed_env() is None
    monkeypatch.setenv("HOCR_DIST_NPROCS", "2")
    monkeypatch.setenv("HOCR_DIST_PROC_ID", "0")
    assert distributed.distributed_env()["process_id"] == 0


def test_torchrun_env_and_placement(monkeypatch):
    """``auto=True``'s torchrun description, and the backend each
    placement takes: gloo without a card, NCCL with a card per process,
    gloo on cuda:0 when the processes outnumber the cards."""
    from handwritten_ocr_tpu_torch.parallel import distributed

    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29501")
    env = distributed._torchrun_env()
    assert env == {"coordinator_address": "10.0.0.2:29501",
                   "num_processes": 8, "process_id": 5}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed._placement(env) == ("gloo", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert distributed._placement(env) == ("nccl", 5)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed._placement(env) == ("nccl", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed._placement(env) == ("gloo", 0)


@pytest.mark.parametrize("case", ["two_hosts_of_8", "one_card",
                                  "no_card", "host_short_of_cards"])
def test_placement_from_each_ranks_host(case):
    """The pure placement rule over every rank's host and card count, as
    the rendezvous gathers them when LOCAL_RANK / LOCAL_WORLD_SIZE are
    unset: 16 ranks on two hosts of 8 cards take NCCL and local ranks
    0-7 on each host; two ranks on a host of one card share cuda:0 over
    gloo; four ranks on a host without a card take gloo and no card; one
    host with fewer cards than ranks puts the whole job on gloo."""
    from handwritten_ocr_tpu_torch.parallel.distributed import placement

    if case == "two_hosts_of_8":
        hosts = ["node-a"] * 8 + ["node-b"] * 8
        got = [placement(hosts, [8] * 16, r) for r in range(16)]
        assert got == [("nccl", r % 8) for r in range(16)]
        mixed = ["node-a", "node-b"] * 8          # ranks interleaved
        got = [placement(mixed, [8] * 16, r) for r in range(16)]
        assert got == [("nccl", r // 2) for r in range(16)]
    elif case == "one_card":
        assert [placement(["h", "h"], [1, 1], r) for r in (0, 1)] == \
            [("gloo", 0), ("gloo", 0)]
    elif case == "no_card":
        assert [placement(["h"] * 4, [0] * 4, r) for r in range(4)] == \
            [("gloo", None)] * 4
    else:
        hosts = ["a"] * 8 + ["b"] * 8
        cards = [8] * 8 + [4] * 8
        assert {placement(hosts, cards, r)[0] for r in range(16)} == {"gloo"}
        assert placement(hosts, cards, 12) == ("gloo", 0)


def test_rendezvous_names_each_ranks_host(monkeypatch):
    """Without LOCAL_* the ranks meet on a TCPStore at the coordinator's
    address: a one-process store here (a job of one) gives back this
    host's name and card count."""
    from handwritten_ocr_tpu_torch.parallel import distributed
    from torch_port_dist import free_port

    env = {"coordinator_address": f"localhost:{free_port()}",
           "num_processes": 1, "process_id": 0}
    store, hosts, cards = distributed._rendezvous(env)
    import socket
    assert hosts == [socket.gethostname()]
    assert cards == [torch.cuda.device_count()
                     if torch.cuda.is_available() else 0]
    assert distributed._placement(env, hosts, cards) == (
        ("gloo", None) if not torch.cuda.is_available() else ("nccl", 0))
    del store


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three pages and one page in a folder of its own; the output of a
    solo run of the three; the two ranks' results over shared output
    folders."""
    root = tmp_path_factory.mktemp("dist_cli")
    pages, single = root / "pages", root / "single"
    pages.mkdir()
    single.mkdir()
    for i, name in enumerate(PAGES):
        _page(pages / name, i)
    _page(single / "only.png", 7)
    shared = root / "shared"
    group = Group(WORLD, cli_and_helpers, [
        [str(pages), "--backend", "dryrun", "--output-dir", str(shared)],
        [str(single), "--backend", "dryrun", "--output-dir",
         str(root / "single_out")]])
    solo = root / "solo"
    transcribe.main([str(pages), "--backend", "dryrun", "--output-dir",
                     str(solo)])
    return solo, shared, root / "single_out", group.results(timeout=240)


def test_each_page_is_written_once_and_equals_a_solo_run(folder):
    solo, shared, _, results = folder
    owned = []
    for rank, result in enumerate(results):
        out = result["stdout"][0]
        names = re.findall(r"Processing: (\S+)", out)
        assert f"[dist] process {rank}/{WORLD}: {len(names)} pages" in out
        assert names == list(sorted(PAGES)[rank::WORLD])
        assert "All done." in out
        owned += names
    assert sorted(owned) == sorted(PAGES)          # each page once
    assert _artifacts(shared) == _artifacts(solo)
    assert len(_artifacts(solo)) == 4 * len(PAGES)


def test_a_rank_that_owns_no_page_returns(folder):
    *_, single_out, results = folder
    first, second = (result["stdout"][1] for result in results)
    assert "[dist] process 0/2: 1 pages" in first
    assert "Processing: only.png" in first
    assert "[dist] process 1/2: 0 pages" in second
    assert "Processing:" not in second and "All done." in second
    assert len(_artifacts(single_out)) == 4


def test_helpers_over_the_group(folder):
    """shard_host_batch asks each rank of a (2, 1) mesh for its own rows
    only; replicate_params over a (1, 2) mesh keeps each rank's slices;
    initialize_from_env is idempotent; only rank 0 coordinates."""
    *_, results = folder
    data = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    down = np.arange(8.).reshape(2, 4)        # row-parallel: in columns
    up = np.arange(8.).reshape(4, 2)          # column-parallel: out rows
    for rank, result in enumerate(results):
        assert (result["data_rank"], result["model_rank"]) == (rank, rank)
        np.testing.assert_array_equal(result["rows"],
                                      data[4 * rank:4 * rank + 4])
        assert len(result["asked"]) == 1
        assert result["coordinator"] == (rank == 0)
        assert result["initialized_again"] is True
        np.testing.assert_array_equal(result["down"],
                                      down[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(result["up"], up[2 * rank:2 * rank + 2])
