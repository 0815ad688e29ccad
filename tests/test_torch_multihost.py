"""The port's multi-process launch layer (``repro_torch.distributed
.multihost``), on the CPU.

In-process tests pin ``initialize``'s one-process no-op, a rendezvous
that fails raising, ``spans_processes`` and ``spawn`` ending a world
whose rank failed. The spawned test is the
twin of ``tests/test_multihost.py``'s acceptance check: two processes,
joined over gloo through a file store in ``tmp_path``, each adding two
CPU slots, run a plain ``queueing.run`` with no ``mesh=`` — the default
mesh ``initialize`` installs spans both — and every process's summaries
must equal one process's unsharded run bit for bit (``torch.equal``),
with each process having drawn only the seed rows its own slots gather.
The file imports no JAX: the spawned processes import it.
"""

import time

import pytest
import torch

from repro_torch.core import chunkflow, queueing
from repro_torch.core import distributions as dists
from repro_torch.core.scenario import Scenario
from repro_torch.distributed import multihost
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.mesh import SweepMesh

CFG = queueing.SimConfig(n_servers=10, n_arrivals=1_500)
# (name, scenario, loads, n_seeds, percentiles): 8 cells on the 4 slots,
# then 6 cells padded to 8; rank 0's slots hold seed 0 in both
GRIDS = (
    ("divisible", Scenario.paper_default(dists.exponential(), ks=(1, 2)),
     (0.15, 0.35), 2, (50.0, 99.0)),
    ("padded", Scenario.paper_default(dists.pareto(2.5), ks=(1, 2)),
     (0.1, 0.25, 0.4), 1, ()),
)
WALL_LIMIT_S = 240.0


def _grid_run(name, scn, rhos, n_seeds, percentiles):
    return queueing.run(3, scn, rhos, CFG, n_seeds=n_seeds,
                        percentiles=percentiles, chunk_size=600,
                        device="cpu")


def _worker(rank: int, store: str, out_dir: str) -> None:
    """One process of the 2 x 2 run: join, run every grid with no mesh,
    save the summaries and the sampling provenance."""
    multihost.initialize(f"file://{store}", 2, rank, local_device_count=2,
                         device="cpu", timeout_s=60.0)
    try:
        out = {}
        for grid in GRIDS:
            s = _grid_run(*grid)
            out[grid[0]] = {"summary": s,
                            "sampling": chunkflow.stats_provenance()}
        out["mesh"] = [(r, str(d)) for r, d in
                       launch_mesh.resolve_mesh().slots]
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        multihost.shutdown()


def _stuck_unless_rank_1(rank: int) -> None:
    """Rank 1 raises; the others wait, as ranks blocked on it in a
    collective would."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(120.0)


def test_spawn_kills_the_world_when_a_rank_fails():
    """``multihost.spawn`` raises as soon as one rank exits nonzero and
    kills the ranks still waiting, well before its deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with"):
        multihost.spawn(_stuck_unless_rank_1, 3, (), 100.0)
    assert time.monotonic() - t0 < 60.0


def test_initialize_is_a_no_op_for_one_process():
    assert multihost.initialize() is False
    assert multihost.initialize("localhost:1234", 1, 0) is False
    assert not multihost.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_coordinator()
    assert multihost.registered_slots() == ()
    assert launch_mesh.resolve_mesh() is None


def test_initialize_raises_when_the_rendezvous_fails(tmp_path):
    # rank 0 of 2 with no rank 1: the run never carries on alone
    try:
        with pytest.raises(RuntimeError):
            multihost.initialize(f"file://{tmp_path / 'store'}", 2, 0,
                                 device="cpu", timeout_s=2.0)
    finally:
        multihost.shutdown()
    assert launch_mesh.resolve_mesh() is None


def test_spans_processes():
    cpu = torch.device("cpu")
    assert not multihost.spans_processes(SweepMesh(((0, cpu),) * 4))
    assert multihost.spans_processes(SweepMesh(((0, cpu), (0, cpu),
                                                (1, cpu), (1, cpu))))
    x = torch.arange(6.0)
    (got,) = multihost.fetch_replicated(SweepMesh(((0, cpu),) * 2), x)
    assert torch.equal(got, x)  # one process: its own cells, on the CPU


@pytest.mark.slow
def test_two_processes_two_slots_equal_one_process_unsharded(tmp_path):
    multihost.spawn(_worker, 2, (str(tmp_path / "store"), str(tmp_path)),
                    WALL_LIMIT_S)

    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["mesh"] == [(0, "cpu"), (0, "cpu"), (1, "cpu"),
                               (1, "cpu")]
        for grid in GRIDS:
            name = grid[0]
            want = _grid_run(*grid)
            summary = got[name]["summary"]
            assert summary["count"] == want["count"]
            for f in ("mean", "completed") + tuple(
                    f"p{q:g}" for q in grid[4]):
                assert torch.equal(summary[f], want[f]), (rank, name, f)
            st = got[name]["sampling"]
            assert (st["process_count"], st["process_index"]) == (2, rank)
        # each rank drew the one seed row its slots gather, of two
        st = got["divisible"]["sampling"]
        assert (st["seed_rows_sampled"], st["seed_rows_total"]) == (1, 2)
        assert st["locality_factor"] == 2.0
