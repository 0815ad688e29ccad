"""The port's figure harness (``repro_torch.bench``) on the CPU at smoke
sizes: every figure and benchmark module returns well-formed rows with
its JAX twin's row labels, in order, and the same derived keys; the
cross-system figure's crossover order and parity row; fig12 through the
chunked engine; the benchmarks' acceptance rows (the twins of
``tests/test_benchmarks_smoke.py``); the three examples at smoke size;
and the harness with the port's new modules imports nothing of JAX, of
``repro`` or of ``benchmarks``."""
import functools
import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import run as bench_run
from repro_torch.bench.common import row_provenance

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MODULES = ["sweep_engine", "fig_policy_space", "fig1_queueing",
           "fig2_threshold", "fig3_random", "fig4_overhead", "fig5_diskdb",
           "fig12_memcached", "fig14_network", "fig15_dns",
           "fig_cross_system", "tab_tcp", "fig_fault_masking",
           "serving_hedge", "roofline"]

NEW_MODULES = (["repro_torch.bench.run", "repro_torch.bench.common",
                "repro_torch.core.storage_sim", "repro_torch.core.dns",
                "repro_torch.core.netsim", "repro_torch.core.analytic",
                "repro_torch.core.scenario", "repro_torch.core.queueing",
                "repro_torch.serving.metrics", "repro_torch.serving.controller",
                "repro_torch.serving.faults", "repro_torch.serving.replay",
                "repro_torch.serving.service",
                "repro_torch.examples.queueing_explorer",
                "repro_torch.examples.serve_hedged",
                "repro_torch.examples.quickstart",
                "repro_torch.launch.mesh", "repro_torch.distributed.multihost",
                "repro_torch.distributed.sweep_shard"]
               + [f"repro_torch.bench.{m}" for m in MODULES])

# sweep_engine's streamed sweep is named by its size; the port's smoke
# streams 20k arrivals (the plain version steps them one at a time on the
# CPU), the JAX module's 200k
STREAMED = re.compile(r"^sweep_engine/chunked_\d+k$")


def _keys(derived: str) -> list[str]:
    """The keys of a ``key=value;...`` field; a field of prose (no ``=``)
    has none."""
    return [part.split("=", 1)[0] for part in derived.split(";")
            if "=" in part]


def _label(name: str) -> str:
    return "sweep_engine/chunked_<size>" if STREAMED.match(name) else name


@functools.lru_cache(maxsize=None)
def port_rows(name: str) -> tuple:
    """The port module's smoke rows on the CPU (run once per process)."""
    return tuple(importlib.import_module(f"repro_torch.bench.{name}").run(
        smoke=True, device="cpu"))


def derived_of(name: str) -> dict:
    """{row label: its derived field as a dict} of a module's smoke rows."""
    return {r[0]: dict(p.split("=", 1) for p in r[2].split(";") if "=" in p)
            for r in port_rows(name)}


@pytest.mark.parametrize("name", MODULES)
def test_smoke_rows_match_the_jax_twin(name):
    rows = port_rows(name)
    want = importlib.import_module(f"benchmarks.{name}").run(smoke=True)
    assert [_label(r[0]) for r in rows] == [_label(r[0]) for r in want]
    for row, ref in zip(rows, want):
        label, us, derived = row[:3]
        assert isinstance(label, str) and "ERROR" not in label
        assert float(us) >= 0.0 and isinstance(derived, str)
        assert _keys(derived) == _keys(ref[2]), (label, derived, ref[2])
        assert ("=" in derived) == ("=" in ref[2]), (label, derived)
        mesh, scn, kernel = row_provenance(row)
        assert mesh is None
        assert kernel in (None, "off")  # resolved on the CPU, never "auto"
        json.dumps(scn)


def test_harness_runs_the_modules_in_the_jax_order():
    assert [m.__name__.split(".")[-1] for m in bench_run.MODULES] == MODULES


def test_fig_policy_space_scenario_provenance():
    by_name = {r[0]: r for r in port_rows("fig_policy_space")}
    _, scn, kernel = row_provenance(by_name["fig_policy_space/iid"])
    assert scn["policy"] == "REPLICATE_ALL" and scn["mix"] == 0.0
    assert kernel == "off"
    _, scn, _ = row_provenance(by_name["fig_policy_space/server_dep_mix1"])
    assert scn["service_model"] == "SERVER_DEPENDENT" and scn["mix"] == 1.0
    _, scn, _ = row_provenance(by_name["fig_policy_space/cancel"])
    assert scn["policy"] == "CANCEL_ON_COMPLETE"
    cross = derived_of("fig_policy_space")["fig_policy_space/crossover"]
    assert cross["crossover"] == "True", cross


def test_sweep_engine_rows():
    d = derived_of("sweep_engine")
    row = next(r for r in port_rows("sweep_engine")
               if r[0] == "sweep_engine/kernel_on_vs_off")
    assert row_provenance(row)[2] == "off"  # no kernel on the CPU
    assert d["sweep_engine/kernel_on_vs_off"]["bit_identical"] == "True"
    assert "speedup" in d["sweep_engine/kernel_on_vs_off"]
    assert d["sweep_engine/pipeline_on_vs_off"]["bit_identical"] == "True"
    # old path and fused engine read the same streams
    assert float(d["sweep_engine/total"]["max_threshold_delta"]) <= 1e-3
    for name, row in d.items():
        if name.startswith("sweep_engine/chunked/"):
            assert row["match"] == "True", (name, row)
    assert "sweep_engine/chunked_20k" in d


def test_sweep_engine_times_one_family_of_the_old_path(capsys):
    from repro_torch.bench import sweep_engine
    assert sweep_engine.main(["--smoke", "--device", "cpu"]) > 0
    out = capsys.readouterr().out
    assert "pareto 6" in out and "5000 arrivals" in out and "cpu" in out


def test_fig_fault_masking_chaos_acceptance():
    d = derived_of("fig_fault_masking")
    chaos, engine = d["fig_fault_masking/chaos"], d["fig_fault_masking/engine"]
    for key in ("hedged_completes_all", "hedged_p99_within_2x",
                "retry_degrades_more", "masked"):
        assert chaos[key] == "True", chaos
    for key in ("retry_completes_all", "completion_order"):
        assert engine[key] == "True", engine


def test_serving_adaptive_vs_static_acceptance():
    by_name = {r[0]: r for r in port_rows("serving_hedge")}
    d = derived_of("serving_hedge")
    assert d["serving/adaptive_vs_static"]["no_worse"] == "True"
    assert d["serving/adaptive_vs_static"]["strictly_better"] == "True"
    _, cmp, _ = row_provenance(by_name["serving/adaptive_vs_static"])
    assert cmp["adaptive_no_worse"] is True
    assert cmp["adaptive_strictly_better"] is True
    assert cmp["controller"]["decisions"] > 0
    json.dumps(cmp)
    table = by_name["serving/policy_table"]
    assert "best@0.10=" in table[2] and "best@0.75=" in table[2]
    _, tab, kernel = row_provenance(table)
    assert len(tab["k"]) == len(tab["delay"]) >= 2 and kernel == "off"
    live = d["serving/batched_live"]
    assert live["completions"] == live["n"] == "60"


def test_roofline_rows_on_the_cards_peaks():
    from repro_torch.bench import roofline
    from repro_torch import device
    d = derived_of("roofline")
    for leg in ("scan", "kernel"):
        row = d[f"roofline/cell_update/{leg}"]
        assert 0 < float(row["peak_frac"]) <= 1
        assert 0 < float(row["hbm_frac"]) <= 1
        assert row["kernel"] == "off"
    assert roofline.RIDGE == device.F32_OPS_PER_S / device.HBM_BYTES_PER_S
    missing = next(r for r in port_rows("roofline")
                   if r[0] == "roofline/dryrun_missing")
    assert "item 15" in missing[2]


def test_sweep_engine_sharded_rows_bit_identical():
    # part 3 on a 2-slot CPU mesh: the smoke rows, then the two sharded
    # rows, each holding the unsharded bits and the mesh shape
    from repro_torch.bench import sweep_engine
    from repro_torch.bench.common import row_sampling
    from repro_torch.launch.mesh import make_sweep_mesh
    rows = sweep_engine.run(smoke=True, device="cpu",
                            mesh=make_sweep_mesh(devices=("cpu",) * 2))
    assert [r[0] for r in rows] == [r[0] for r in port_rows(
        "sweep_engine")] + ["sweep_engine/sharded/sweep_d2",
                            "sweep_engine/sharded/thresholds_d2"]
    for row in rows[-2:]:
        derived = dict(p.split("=", 1) for p in row[2].split(";"))
        assert derived["bit_identical"] == "True", row
        assert derived["devices"] == "2"
        assert row_provenance(row)[0] == [2]
    assert row_sampling(rows[-2])["seed_rows_total"] == 2
    assert row_sampling(next(r for r in rows if r[0] ==
                             "sweep_engine/pipeline_on_vs_off"))[
        "n_chunks"] == 5


def test_queueing_explorer_devices_prints_the_mesh(capsys):
    from repro_torch.examples import queueing_explorer
    out = queueing_explorer.main(["--devices", "2", "--device", "cpu",
                                  "--arrivals", "3000"])
    un = queueing_explorer.main(["--device", "cpu", "--arrivals", "3000"])
    text = capsys.readouterr().out
    assert "mesh = 2-way 'cells'" in text
    assert torch.equal(out["summary"]["mean"], un["summary"]["mean"])
    assert out["threshold"] == un["threshold"]


def test_queueing_explorer_smoke(capsys):
    from repro_torch.examples import queueing_explorer
    out = queueing_explorer.main(["--family", "pareto", "--param", "2.1",
                                  "--k", "1", "2", "3", "--arrivals",
                                  "3000", "--policy", "cancel_on_complete",
                                  "--device", "cpu"])
    assert out["summary"]["mean"].shape == (1, 4, 3)
    assert 0.0 < out["threshold"] <= 0.5
    text = capsys.readouterr().out
    assert "policy = cancel_on_complete" in text and "kernel = off" in text


def test_quickstart_smoke(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--smoke", "--device", "cpu"])
    assert abs(out["threshold"] - 1 / 3) < 0.1
    assert out["gain"][0] > 0 > out["gain"][-1]  # helps low, hurts high
    assert all(g > 0 for g in out["gain_cancel"])
    assert out["fault_completed"][1] == 1.0  # retry completes all
    assert len(out["crash_latency_s"]) == 20
    assert out["controller"].decisions > 0
    assert "adaptive serving" in capsys.readouterr().out


def test_serve_hedged_smoke(capsys):
    from repro_torch.examples import serve_hedged
    out = serve_hedged.main(["--smoke", "--device", "cpu",
                             "--requests", "8"])
    for run in ("adaptive", "crash"):
        assert out[run]["telemetry"]["completions"] == 8
        assert out[run]["stats"]["failed"] == 0
    assert "controller mean k by phase" in capsys.readouterr().out


def test_fig_cross_system_crossover_row():
    from repro_torch.bench import fig_cross_system as fcs
    rows = fcs.run(smoke=True, device="cpu")
    by_name = {r[0]: r for r in rows}
    cross = by_name["fig_cross_system/crossover"][2]
    for system in ("disk", "memcached", "dns"):
        assert f"{system}=" in cross, cross
    assert "order=" in cross, cross
    assert cross.index("memcached=") > cross.index("disk="), cross
    _, scn, kernel = row_provenance(by_name["fig_cross_system/disk"])
    assert scn["ks"] == [1, 2] and len(scn["dists"]) == 1
    assert kernel == "off"
    parity = by_name["fig_cross_system/kernel_parity"][2]
    assert "bit_identical=True" in parity and "kernel=off" in parity, parity


def test_fig12_accepts_chunked_engine_config():
    from repro_torch.bench import fig12_memcached as fig12
    rows = fig12.run(smoke=True, chunk_size=1_024, device="cpu")
    assert rows and all("ERROR" not in r[0] for r in rows)
    unchunked = fig12.run(smoke=True, device="cpu")
    assert [r[0] for r in rows] == [r[0] for r in unchunked]


def test_engine_figures_are_reproducible_summaries():
    # the figures draw from seeded generators only: two runs of the plain
    # path give the same summaries bit for bit (the kernel-against-plain
    # comparison of compute() needs the card: chip_smoke.py's phase 13)
    from repro_torch.bench import fig5_diskdb
    a, _ = fig5_diskdb.compute(smoke=True, kernel="off", device="cpu")
    b, _ = fig5_diskdb.compute(smoke=True, kernel="off", device="cpu")
    for key in ("mean", "p99", "p99.9"):
        assert (a["summaries"][key] == b["summaries"][key]).all()
    assert (a["gain"] == b["gain"]).all()


def test_harness_json_rows(tmp_path):
    path = tmp_path / "BENCH_smoke.json"
    out = bench_run.main(["--smoke", "--device", "cpu", "--only", "tab_tcp",
                          "--only", "fig12", "--json", str(path)])
    rows = json.loads(path.read_text())
    assert rows == out["rows"]
    assert set(out["walls"]) == {"fig12_memcached", "tab_tcp"}
    for row in rows:
        assert row["backend"] == "torch" and row["device"] == "cpu"
        assert row["gpu"] == "cpu" and row["mesh"] is None
    engine = [r for r in rows if r["name"].startswith("fig12/")]
    assert engine and all(r["kernel"] == "off" and r["scenario"]
                          for r in engine)
    assert next(r for r in rows if r["name"] == "tcp/handshake")[
        "kernel"] is None


@pytest.mark.parametrize("kernel,device,mode", [
    ("auto", "cpu", "off"), ("off", "cpu", "off"), ("auto", "cuda", "on"),
    ("on", "cuda", "on"), ("off", "cuda", "off"), ("on", "cpu", None)])
def test_rows_record_the_mode_the_ops_dispatch(kernel, device, mode):
    # the rows' ``kernel`` field and the ops' launch decision are one rule
    from repro_torch.kernels import dispatch
    if mode is None:
        with pytest.raises(RuntimeError, match="CUDA"):
            dispatch.resolve(kernel, device)
        return
    assert dispatch.resolve(kernel, device) == mode
    assert dispatch.resolve(kernel, torch.device(device)) == mode
    if device == "cpu":
        x = torch.zeros(2)
        assert dispatch.use_kernel(kernel, x, x) == (mode == "on")


def test_harness_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_run.main(["--only", "tab_tcp"])


def test_new_modules_import_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
