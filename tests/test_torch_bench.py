"""The port's figure harness (``repro_torch.bench``) on the CPU at smoke
sizes: every figure module returns well-formed rows with its JAX twin's
row labels, in order, and the same derived keys; the cross-system
figure's crossover order and parity row; fig12 through the chunked
engine; and the harness with the port's new modules imports nothing of
JAX, of ``repro`` or of ``benchmarks``."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import run as bench_run
from repro_torch.bench.common import row_provenance

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MODULES = ["fig1_queueing", "fig2_threshold", "fig3_random",
           "fig4_overhead", "fig5_diskdb", "fig12_memcached",
           "fig14_network", "fig15_dns", "fig_cross_system", "tab_tcp"]

NEW_MODULES = (["repro_torch.bench.run", "repro_torch.bench.common",
                "repro_torch.core.storage_sim", "repro_torch.core.dns",
                "repro_torch.core.netsim", "repro_torch.core.analytic",
                "repro_torch.core.scenario", "repro_torch.core.queueing"]
               + [f"repro_torch.bench.{m}" for m in MODULES])


def _keys(derived: str) -> list[str]:
    return [part.split("=", 1)[0] for part in derived.split(";")]


@pytest.mark.parametrize("name", MODULES)
def test_smoke_rows_match_the_jax_twin(name):
    rows = importlib.import_module(f"repro_torch.bench.{name}").run(
        smoke=True, device="cpu")
    want = importlib.import_module(f"benchmarks.{name}").run(smoke=True)
    assert [r[0] for r in rows] == [r[0] for r in want]
    for row, ref in zip(rows, want):
        label, us, derived = row[:3]
        assert isinstance(label, str) and "ERROR" not in label
        assert float(us) >= 0.0 and isinstance(derived, str)
        assert _keys(derived) == _keys(ref[2]), (label, derived, ref[2])
        mesh, scn, kernel = row_provenance(row)
        assert mesh is None
        assert kernel in (None, "off")  # resolved on the CPU, never "auto"
        json.dumps(scn)


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
