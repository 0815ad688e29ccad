"""Host-side plans of the port's CUDA kernels, on the CPU: the split plan
of ``decode_attention`` (from the cache's shape and the card's SM count),
the launch plan of ``cell_update`` (template, cells per block, tile,
stages and shared memory, from the chunk's shape) and the per-source
``nvcc`` flags. The kernels themselves run only on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""
import re

import pytest

from repro_torch import interop
from repro_torch.kernels import build
from repro_torch.kernels.cell_update import kernel as cell_kernel
from repro_torch.kernels.decode_attention import kernel as da_kernel

H100_SMS = 132


def _cu_constant(source: str, name: str) -> int:
    text = (build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    value = m.group(1)
    if value.isdigit():
        return int(value)
    # an expression over other constants of the source, e.g. 32 * (2 + kP)
    names = set(re.findall(r"[A-Za-z_]\w*", value))
    return eval(value, {}, {n: _cu_constant(source, n) for n in names})


def test_decode_constants_match_the_source():
    # kCluster and kMaxSplit the wrapper checks against the library itself
    assert _cu_constant("decode_attention", "kMaxGroup") == \
        da_kernel.MAX_GROUP
    assert _cu_constant("decode_attention", "kMaxHeadDim") == \
        da_kernel.MAX_HEAD_DIM


@pytest.mark.parametrize("case", [
    # (cache length, batch, KV heads, SMs)
    (4672, 1, 4, H100_SMS),   # gemma2-2b's dense cache in chip_smoke.py
    (4096, 1, 4, H100_SMS),   # gemma2-2b's local ring
    (2048, 1, 1, H100_SMS),   # recurrentgemma-9b's MQA ring
    (8192, 1, 4, H100_SMS),
    (8192, 2, 4, H100_SMS),
    (128, 1, 4, H100_SMS),    # the served path's dense cache
    (300, 2, 4, H100_SMS),
    (100_000, 1, 1, H100_SMS),
    (1, 1, 1, H100_SMS),
    (77, 3, 2, 8),
])
def test_split_plan_covers_the_cache_and_fills_the_card(case):
    length, batch, n_kv, n_sm = case
    split, n_splits = da_kernel.split_plan(length, batch, n_kv, n_sm)
    assert da_kernel.MIN_SPLIT <= split <= da_kernel.MAX_SPLIT
    assert n_splits % da_kernel.CLUSTER == 0
    assert split * n_splits >= length
    # at most one cluster's worth of splits lies wholly past the cache
    assert split * (n_splits - da_kernel.CLUSTER) < length
    if length >= 2 * n_sm * da_kernel.MIN_SPLIT:
        assert batch * n_kv * n_splits >= 2 * n_sm


@pytest.mark.parametrize("length,batch,n_kv", [(4672, 1, 4), (2048, 1, 1)])
def test_split_plan_of_the_main_path_gives_264_ctas(length, batch, n_kv):
    split, n_splits = da_kernel.split_plan(length, batch, n_kv, H100_SMS)
    assert batch * n_kv * n_splits >= 264
    assert split * n_splits >= length


def test_split_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        da_kernel.split_plan(0, 1, 1, H100_SMS)
    with pytest.raises(ValueError):
        da_kernel.split_plan(16, 1, 1, 0)


@pytest.mark.parametrize("name", build.SOURCES)
def test_fmad_off_only_where_bits_are_held(name):
    flags = build.nvcc_flags(name)
    bits = name in ("hist_sketch", "cell_update", "rglru_scan", "ssd_scan")
    assert ("--fmad=false" in flags) == bits
    assert ("-lcuda" in flags) == (name in ("flash_attention", "rglru_scan"))
    assert "arch=compute_90a,code=sm_90a" in flags


def test_library_digest_covers_each_sources_own_flags(monkeypatch):
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert len(set(before.values())) == len(build.SOURCES)
    monkeypatch.setattr(build, "NO_FMAD", ())
    after = {n: build.library_path(n) for n in build.SOURCES}
    for name in build.SOURCES:
        assert (after[name] == before[name]) == (name not in (
            "hist_sketch", "cell_update", "rglru_scan", "ssd_scan"))
    with pytest.raises(ValueError):
        build.nvcc_flags("no_such_kernel")


def test_cell_update_constants_match_the_source():
    for name, value in (("kMaxK", cell_kernel.MAX_K),
                        ("kMaxServers", cell_kernel.MAX_SERVERS),
                        ("kMaxCells", cell_kernel.MAX_CELLS),
                        ("kProducers", cell_kernel.PRODUCERS),
                        ("kThreads", cell_kernel.THREADS),
                        ("kMaxStages", cell_kernel.MAX_STAGES),
                        ("kFlushSteps", cell_kernel.FLUSH_STEPS),
                        ("kMaxSmem", cell_kernel.MAX_SMEM_BYTES),
                        ("kStaticSmem", cell_kernel.STATIC_SMEM_BYTES)):
        assert _cu_constant("cell_update", name) == value, name
    text = (build.CSRC / "cell_update.cu").read_text()
    # the launcher accepts exactly the plan's templates, tiles and stages
    assert "K == 1 || K == 2 || K == 3 || K == 4 || K == 8 || K == 16" in text
    assert cell_kernel.K_TEMPLATES == (1, 2, 3, 4, 8, 16)
    assert "(TS != 16 && TS != 32 && TS != 64)" in text
    assert sorted(cell_kernel.TILES) == [16, 32, 64]
    assert "(Q != 4 && Q != kMaxStages)" in text
    assert sorted(cell_kernel.STAGES) == [4, cell_kernel.MAX_STAGES]
    # every stage is used by one producer only; stages are a power of two
    assert all(q % cell_kernel.PRODUCERS == 0 and q & (q - 1) == 0
               for q in cell_kernel.STAGES)
    assert "L.Q == 8 ? 3 : 2" in text
    # 16-bit counters never overflow between flushes; the flush falls on a
    # tile boundary at every tile
    assert cell_kernel.FLUSH_STEPS < 1 << 16
    assert all(cell_kernel.FLUSH_STEPS % t == 0 for t in cell_kernel.TILES)
    # a tile is whole groups of four steps (the producers' and the
    # histogram warp's)
    assert all(t % 4 == 0 for t in cell_kernel.TILES)


def _plan(**kw):
    shape = dict(n_cells=1440, n_servers=20, k_max=2, n_svc=2, n_bins=0,
                 n_steps=4096, seed_rows=2, svc_rows=30, timed=False)
    shape.update(kw)
    return cell_kernel.launch_plan(**shape), shape


def _smem(plan, shape):
    return cell_kernel.smem_bytes(
        cells=plan.cells, tile=plan.tile, stages=plan.stages,
        n_servers=shape["n_servers"], k_template=plan.k_template,
        k_max=shape["k_max"], n_svc=shape["n_svc"], n_bins=shape["n_bins"],
        seed_rows=min(plan.cells, shape["seed_rows"]),
        svc_rows=min(plan.cells, shape["svc_rows"]), timed=shape["timed"])


BUDGET = cell_kernel.MAX_SMEM_BYTES - cell_kernel.STATIC_SMEM_BYTES


@pytest.mark.parametrize("k_max", range(1, 17))
def test_cell_plan_takes_the_smallest_template(k_max):
    plan, _ = _plan(k_max=k_max, n_svc=k_max)
    assert plan.k_template in cell_kernel.K_TEMPLATES
    assert plan.k_template >= k_max
    smaller = [k for k in cell_kernel.K_TEMPLATES if k < plan.k_template]
    assert not smaller or max(smaller) < k_max


def test_cell_plan_of_the_main_path():
    # the fig2 chunk: a full block of 32 cells, 30 seed rows
    plan, shape = _plan(seed_rows=30, svc_rows=30)
    assert (plan.k_template, plan.cells, plan.tile, plan.stages,
            plan.blocks) == (2, 32, 16, 8, 45)
    assert plan.smem_bytes == _smem(plan, shape) <= BUDGET
    # the percentile run's chunk: 12 cells in one block, 2048 bins
    plan, shape = _plan(n_cells=12, n_bins=2048, svc_rows=2)
    assert (plan.cells, plan.blocks) == (12, 1)
    assert plan.smem_bytes == _smem(plan, shape) <= BUDGET


@pytest.mark.parametrize("k_template", (1, 2, 3, 4, 8, 16))
@pytest.mark.parametrize("n_servers", (20, 1000, 1816, 16_384))
@pytest.mark.parametrize("n_bins", (0, 100, 2048, 58_112))
@pytest.mark.parametrize("timed", (False, True))
def test_cell_plan_fits_the_shared_memory(k_template, n_servers, n_bins,
                                          timed):
    # degraded SERVER_DEPENDENT services: the widest rows there are
    k_max = min(k_template, n_servers)
    plan, shape = _plan(n_cells=1440, n_servers=n_servers, k_max=k_max,
                        n_svc=2 * k_max + 1, n_bins=n_bins, svc_rows=30,
                        timed=timed)
    assert plan.k_template == k_template
    assert plan.smem_bytes == _smem(plan, shape) <= BUDGET
    assert plan.blocks == -(-1440 // plan.cells)
    assert plan.tile in cell_kernel.TILES
    assert plan.stages in cell_kernel.STAGES
    # no preferred choice fits: more cells, a longer tile or more stages
    bigger = [(g, t, q) for g in (32, 16, 8, 4, 2, 1)
              for t in cell_kernel.TILES for q in cell_kernel.STAGES
              if (g, t, q) > (plan.cells, plan.tile, plan.stages)]
    for g, t, q in bigger:
        alt = cell_kernel.LaunchPlan(plan.k_template, g, t, q, 0, 0)
        assert _smem(alt, shape) > BUDGET, (g, t, q)


@pytest.mark.parametrize("n_steps,tile", [(1, 16), (16, 16), (17, 32),
                                          (63, 64), (4096, 64)])
def test_cell_plan_tile_follows_a_short_chunk(n_steps, tile):
    plan, _ = _plan(n_steps=n_steps, n_cells=12, svc_rows=2)
    assert plan.tile == tile


@pytest.mark.parametrize("shape", [
    dict(n_servers=cell_kernel.MAX_SERVERS + 1),
    dict(k_max=17, n_svc=17),
    dict(k_max=21, n_servers=20),
    dict(n_cells=0),
    dict(n_steps=0),
    dict(n_bins=200_000),       # one cell's counters alone overflow
])
def test_cell_plan_rejects_what_does_not_fit(shape):
    with pytest.raises(ValueError):
        _plan(**shape)


def test_cell_edges_reach_the_kernels_limits():
    edges = interop.CELL_UPDATE_EDGES.values()
    assert max(e.get("n_servers", 20) for e in edges) == \
        cell_kernel.MAX_SERVERS
    assert max(e["steps"] for e in edges) > cell_kernel.FLUSH_STEPS
    templates = {cell_kernel.launch_plan(
        n_cells=e["n_cells"], n_servers=e.get("n_servers", 20),
        k_max=e["k_max"], n_svc=e["k_max"], n_bins=0, n_steps=e["steps"],
        seed_rows=2, svc_rows=2, timed=False).k_template for e in edges}
    assert templates == set(cell_kernel.K_TEMPLATES)
    assert any(e["steps"] % min(cell_kernel.TILES) for e in edges)


def test_cell_edges_count_steps_in_their_last_partial_tile():
    # a kernel that skipped the last, partial tile of a chunk must change a
    # count: at every tile that leaves one, it holds a counted step (one of
    # [warmup, T - pad))
    for name, e in interop.CELL_UPDATE_EDGES.items():
        steps, pad, warmup = e["steps"], e.get("pad", 0), e.get("warmup", 100)
        for tile in cell_kernel.TILES:
            part = steps % tile
            if part:
                assert pad < part and warmup < steps - pad, (name, tile)
