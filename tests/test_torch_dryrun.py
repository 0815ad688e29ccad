"""The port's dry-run cost analysis on the CPU (``repro_torch.launch
.hlo_analysis``, ``repro_torch.launch.dryrun``): the twins of
``tests/test_dryrun_integration.py``'s ``TestHLOAnalysis`` (a loop of
products counted each time it runs, a rematerialised block's recompute
counted, collectives seen in a 2-rank world, fake and real, with the same
bytes; bytes per dtype), the FLOPs of a smoke ``train_4k``-shaped step
under the sequence-sharded layout against the JAX package's
``hlo_analysis.analyze`` of the same step (a subprocess with 8 host
devices), and one full-size cell end to end in a subprocess.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import collectives, multihost
from repro_torch.launch import dryrun, hlo_analysis

SRC = Path(__file__).resolve().parent.parent / "src"
FIELDS = ("ok", "devices", "scaled_flops", "scaled_io_bytes",
          "collective_bytes", "argument_size_in_bytes",
          "output_size_in_bytes", "temp_size_in_bytes", "trace_s")
# the smoke step held against JAX: gemma2-2b's smoke config, 8 rows of 64
# positions on a (pod 2, data 2, model 2) mesh (the sequence over pod)
SMOKE_ARCH, SMOKE_SEQ, SMOKE_BATCH = "gemma2-2b", 64, 8
# |port - JAX| / JAX of a rank's FLOPs: measured 0.040 (the port
# 150,994,944, JAX 157,286,400: XLA's per-device program makes 6,291,456
# more, three products of the head's size, 2 x 32 x 64 x 512 each, which
# was not traced further), held within 2.5 times that
JAX_FLOPS_RTOL = 0.1


@pytest.fixture
def fake_pair():
    """A fake process group of 2 ranks (this process rank 0)."""
    dryrun.fake_world(2)
    try:
        yield
    finally:
        dist.destroy_process_group()
        collectives.forget_groups()


def test_loop_counts_every_product():
    x = torch.randn(128, 128)

    def f(x):
        for _ in range(10):
            x = x @ x * 1e-2
        return x

    res = hlo_analysis.analyze(f, x)
    assert res["flops"] == pytest.approx(10 * 2 * 128**3, rel=0.01)
    # ten products (2 in + 1 out) and ten scalings by a Python number
    # (1 in + 1 out), 64 KiB each
    assert res["io_bytes"] == pytest.approx(10 * 5 * 128 * 128 * 4,
                                            rel=0.01)
    assert res["collective_bytes"] == {}


def test_remat_recompute_is_counted():
    """A checkpointed block's forward runs again in backward: three
    products of the block's two counted forward, one again in the
    recompute, plus the backward's."""
    from torch.utils.checkpoint import checkpoint

    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(32, 64)
    one = 2 * 32 * 64 * 64

    def block(x):
        return torch.tanh(x @ w)

    def plain():
        block(block(x)).sum().backward()

    def remat():
        checkpoint(lambda h: block(block(h)), x,
                   use_reentrant=False).sum().backward()

    base = hlo_analysis.analyze(plain)["flops"]
    again = hlo_analysis.analyze(remat)["flops"]
    # forward 2, backward: dW twice and dX once (x needs none)
    assert base == pytest.approx(5 * one)
    assert again - base == pytest.approx(2 * one)


def test_tensor_bytes_per_dtype():
    nb = hlo_analysis.tensor_bytes
    assert nb(torch.empty(2, 3)) == 24
    assert nb(torch.empty(4, 4, dtype=torch.bfloat16)) == 32
    assert nb((torch.empty(2), torch.empty(3, dtype=torch.int32))) == 8 + 12
    assert nb({"a": [torch.empty(5, dtype=torch.int64)], "b": 3}) == 40


def _collective_step(mesh):
    """A row-split product summed over the ranks (the JAX test's forced
    cross-device reduce) and a gather of the rows."""
    x = torch.ones(128, 128)
    w = torch.ones(128, 128)
    y = collectives.all_reduce((x @ w).sum(0), mesh, ("x",))
    return collectives.all_gather(x, mesh, ("x",), 0), y


def test_collectives_in_a_fake_world(fake_pair):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("x",))
    collectives.mesh_grid(mesh)
    with dryrun._fake_mode():
        res = hlo_analysis.analyze(_collective_step, mesh)
    assert res["collective_bytes"] == {"all-reduce": 128 * 4,
                                       "all-gather": 256 * 128 * 4}
    assert res["flops"] == 2 * 128**3


def _gloo_rank(rank: int, store: str, out: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", 2, rank, device="cpu",
                         set_default_mesh=False, timeout_s=60.0)
    try:
        mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("x",))
        res = hlo_analysis.analyze(_collective_step, mesh)
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        multihost.shutdown()


def test_collectives_in_a_gloo_world_match_the_fake_one(tmp_path):
    multihost.spawn(_gloo_rank, 2, (str(tmp_path / "store"),
                                    str(tmp_path / "r0.json")), 120.0)
    res = json.loads((tmp_path / "r0.json").read_text())
    assert res["collective_bytes"] == {"all-reduce": 128 * 4,
                                       "all-gather": 256 * 128 * 4}


def test_failed_cell_is_recorded_and_exits_nonzero(tmp_path):
    with pytest.raises(SystemExit, match="1 dry-run cells failed"):
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "no-such-arch_train_4k_single.json")
                     .read_text())
    assert rec["ok"] is False and "no-such-arch" in rec["error"]
    assert "traceback" in rec
    assert not dist.is_initialized()


def test_one_full_size_cell_end_to_end(tmp_path):
    """mamba2-370m ``decode_32k`` on the single mesh, as a user runs it,
    in a subprocess (one process stands in for a rank of 256)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "mamba2-370m_decode_32k_single.json")
                     .read_text())
    assert rec["ok"], rec.get("error")
    assert rec["devices"] == 256
    for field in FIELDS:
        assert field in rec, field
    assert rec["scaled_flops"] > 0 and rec["scaled_io_bytes"] > 0
    # the KV-split state: the model axis's all-reduces and the
    # inference blocks' gathers
    assert sum(rec["collective_bytes"].values()) > 0
    assert set(rec["collective_bytes"]) <= set(
        hlo_analysis.COLLECTIVES) | {"broadcast"}
    assert rec["argument_size_in_bytes"] > 0
    assert rec["temp_size_in_bytes"] > 0


JAX_FLOPS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_smoke_config
from repro.configs.base import InputShape
from repro.distributed import sharding
from repro.launch import hlo_analysis, specs as sp
from repro.training.optimizer import make_optimizer
from repro.training.step import make_train_step

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
cfg = get_smoke_config(arch)
shape = InputShape("smoke", seq, batch, "train")
layout = sharding.make_layout(cfg, "train", True, batch)
ctx = sharding.make_ctx(cfg, mesh, layout)


def put(shapes, shardings):
    return jax.tree.map(lambda s, ns: jax.ShapeDtypeStruct(
        s.shape, s.dtype, sharding=ns), shapes, shardings)


params = sp.param_specs(cfg)
p_sh = sharding.param_shardings(cfg, mesh, params, inference=False,
                                ep_axes=layout.ep_axes)
opt = make_optimizer(cfg.optimizer)
opt_shapes = sp.opt_state_specs(cfg, params)
o_sh = sharding.opt_shardings(cfg, mesh, opt_shapes, params)
data = sp.batch_specs(cfg, shape)
b_sh = sharding.batch_shardings(cfg, mesh, layout, data)
step = make_train_step(cfg, opt, ctx=ctx)
hlo = jax.jit(step, donate_argnums=(0, 1),
              out_shardings=(p_sh, o_sh, None)).lower(
    put(params, p_sh), put(opt_shapes, o_sh), put(data, b_sh),
    jax.ShapeDtypeStruct((), jnp.int32)).compile().as_text()
print("JAX_FLOPS " + json.dumps(hlo_analysis.analyze(hlo)))
"""


def test_smoke_step_flops_match_jax_hlo_analysis():
    """A rank's FLOPs of the smoke ``train_4k``-shaped step under the
    sequence-sharded layout (8 fake ranks) against the JAX package's
    count of the same step's per-device HLO, within ``JAX_FLOPS_RTOL``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_FLOPS, SMOKE_ARCH, str(SMOKE_SEQ),
         str(SMOKE_BATCH)], env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        from repro_torch.launch.mesh import make_test_mesh

        dryrun.fake_world(8)
        mesh = make_test_mesh(2, 2, n_pod=2)
        collectives.mesh_grid(mesh)
        cfg = get_smoke_config(SMOKE_ARCH)
        shape = InputShape("smoke", SMOKE_SEQ, SMOKE_BATCH, "train")
        rec = dryrun.trace(lambda: dryrun._step(cfg, shape, True, mesh))
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
            collectives.forget_groups()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("JAX_FLOPS "))
    want = json.loads(line[10:])
    gap = abs(rec["scaled_flops"] - want["flops"]) / want["flops"]
    print(f"port {rec['scaled_flops']} JAX {want['flops']} gap {gap}; "
          f"collective bytes port {rec['collective_bytes']} JAX "
          f"{want['collective_bytes']}")
    assert gap <= JAX_FLOPS_RTOL, (rec["scaled_flops"], want["flops"])
    assert sum(rec["collective_bytes"].values()) > 0


def test_dry_run_modules_import_no_jax():
    mods = ["repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
            "repro_torch.bench.roofline"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
              "('jax.', 'repro.')) or m == 'repro']\n"
              "assert not bad, bad\nprint('NO_JAX_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO_JAX_OK" in out.stdout


def test_closed_form_scan_is_the_walk():
    """The dry run's stand-in for the plain RG-LRU walk computes the same
    function (gates in (0, 1), as the RG-LRU's are), with and without
    ``h0``, and is what the scan op takes while tracing."""
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan.ref import linear_scan_ref

    gen = torch.Generator().manual_seed(0)
    a = torch.rand(2, 64, 8, generator=gen) * 0.5 + 0.45
    b = torch.randn(2, 64, 8, generator=gen)
    h0 = torch.randn(2, 8, generator=gen)
    for init in (None, h0):
        torch.testing.assert_close(dryrun._closed_form_scan(a, b, init),
                                   linear_scan_ref(a, b, init), rtol=1e-4,
                                   atol=1e-4)
    with dryrun._closed_form_scans():
        assert scan_ops.linear_scan_ref is dryrun._closed_form_scan
    assert scan_ops.linear_scan_ref is linear_scan_ref
