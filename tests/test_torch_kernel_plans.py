"""Host-side plans of the port's CUDA kernels, on the CPU: the split plan
of ``decode_attention`` (from the cache's shape and the card's SM count),
the launch plan of ``cell_update`` (template, cells per block, tile,
stages and shared memory, from the chunk's shape), the launch plan of
``hist_accum`` (cells a CTA, loads, clusters along T and the clusters'
split of the bins, emulated in numpy against the plain version) and the
per-source ``nvcc`` flags. The kernels themselves run only on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.kernels import build
from repro_torch.kernels.cell_update import kernel as cell_kernel
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.hist_sketch import kernel as hist_kernel
from repro_torch.kernels.hist_sketch.ref import hist_accum_ref

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


def test_hist_constants_match_the_source():
    for name, value in (("kThreads", hist_kernel.THREADS),
                        ("kUnroll", hist_kernel.UNROLL),
                        ("kMaxGroup", hist_kernel.MAX_GROUP),
                        ("kMaxCluster", hist_kernel.MAX_CLUSTER),
                        ("kMaxSmem", hist_kernel.MAX_SMEM_BYTES),
                        ("kMaxGroups", hist_kernel.MAX_GROUPS)):
        assert _cu_constant("hist_sketch", name) == value, name
    text = (build.CSRC / "hist_sketch.cu").read_text()
    # the histogram's padding and the shares' arithmetic are the plan's
    assert "return (G * n_bins + 3) & ~3;" in text
    assert "const int per = (total + 4 * K - 1) / (4 * K) * 4;" in text
    assert "const int lo = min(total, rank * per);" in text
    assert "const int hi = min(total, lo + per);" in text
    assert max(hist_kernel.GROUPS) == hist_kernel.MAX_GROUP
    assert hist_kernel.MAX_BINS == hist_kernel.MAX_SMEM_BYTES // 4


HIST_SHAPES = sorted({(t, c, nb) for t, c, nb, _ in
                      interop.HIST_ACCUM_CASES.values()}
                     | {(t, c, nb) for nb in (100, 256, 2048)
                        for t, c in ((4096, 16), (4096, 1440), (777, 37))}
                     | {(1, 1, 1), (5, 3, 7), (65_536, 1, 2048),
                        (4096, 500_000, 16)})


@pytest.mark.parametrize("t,c,n_bins", HIST_SHAPES)
@pytest.mark.parametrize("aligned", (True, False))
def test_hist_plan_covers_every_entry_once(t, c, n_bins, aligned):
    plan = hist_kernel.launch_plan(t, c, n_bins, H100_SMS, aligned=aligned)
    assert plan.cells in hist_kernel.GROUPS and plan.vec in (1, 4)
    if plan.vec == 4:
        assert aligned and plan.cells % 4 == 0 and c % 4 == 0
    # rows: CTA x takes steps [x S, (x + 1) S); cells: group y takes
    # [y G, (y + 1) G); each step and each cell once, so each (t, c) once
    n_x = plan.cluster * plan.clusters_t
    rows = np.zeros(t, np.int64)
    for x in range(n_x):
        rows[x * plan.slice:(x + 1) * plan.slice] += 1
    assert (rows == 1).all()
    assert plan.groups == -(-c // plan.cells) <= hist_kernel.MAX_GROUPS
    assert (plan.groups - 1) * plan.cells < c
    # inside a CTA: cells // vec threads a step, each of vec cells, the
    # rest of the threads along the steps
    cols = plan.cells // plan.vec
    assert cols * plan.vec == plan.cells and hist_kernel.THREADS % cols == 0
    # clusters only where the groups leave SMs idle, and then enough CTAs
    # for one an SM (or one a step)
    n_x = plan.cluster * plan.clusters_t
    if plan.groups >= H100_SMS:
        assert n_x == 1
    else:
        assert plan.ctas >= min(H100_SMS, plan.groups * t)
        assert plan.cluster * (plan.clusters_t - 1) < -(-H100_SMS
                                                        // plan.groups)
    assert 4 * hist_kernel.hist_words(plan.cells, n_bins) <= hist_kernel.MAX_SMEM_BYTES
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.cluster <= hist_kernel.MAX_CLUSTER


@pytest.mark.parametrize("cells", range(1, hist_kernel.MAX_GROUP + 1))
@pytest.mark.parametrize("n_bins", (1, 3, 100, 2048, 7300,
                                    hist_kernel.MAX_BINS))
def test_hist_cluster_splits_the_bins(cells, n_bins):
    for cluster in (1, 2, 4, 8):
        shares = [hist_kernel.bin_share(r, cluster, cells, n_bins)
                  for r in range(cluster)]
        # rank order, no gap, no overlap, from 0 to the group's last bin
        assert shares[0][0] == 0 and shares[-1][1] == cells * n_bins
        for (lo, hi), (lo2, _) in zip(shares, shares[1:]):
            assert lo <= hi == lo2
        # 16-byte reads of the peers' histograms: every share starts on one
        assert all(lo % 4 == 0 for lo, hi in shares if lo < hi)


@pytest.mark.parametrize("n_bins", (1, 100, 2048, 7264, 7265, 14_528,
                                    14_529, 29_056, 29_057,
                                    hist_kernel.MAX_BINS))
@pytest.mark.parametrize("c", (1, 12, 1440, 65_535))
def test_hist_plan_fits_the_shared_memory(n_bins, c):
    plan = hist_kernel.launch_plan(4096, c, n_bins, H100_SMS)
    assert 4 * hist_kernel.hist_words(plan.cells, n_bins) <= hist_kernel.MAX_SMEM_BYTES
    # no wider group that fits would still leave two groups an SM
    for g in (g for g in hist_kernel.GROUPS if g > plan.cells):
        assert (4 * hist_kernel.hist_words(g, n_bins)
                > hist_kernel.MAX_SMEM_BYTES or -(-c // g) < 2 * H100_SMS)


@pytest.mark.parametrize("t,c", [(4096, 12), (4096, 1440)])
def test_hist_plan_fills_the_card(t, c):
    # the percentile chunk and phase 2's widest shape, 2048 bins
    plan = hist_kernel.launch_plan(t, c, 2048, H100_SMS)
    assert plan.ctas >= H100_SMS
    # few cells: one a CTA, the steps over clusters of 8; many: 4 a CTA
    # (two groups an SM), 16-byte loads, no cluster
    assert (plan.cells, plan.vec, plan.cluster) == (
        (1, 1, 8) if c == 12 else (4, 4, 1))


def test_hist_plan_rejects_what_no_launch_takes():
    for n_bins in (0, hist_kernel.MAX_BINS + 1):
        with pytest.raises(ValueError, match="n_bins"):
            hist_kernel.launch_plan(4096, 12, n_bins, H100_SMS)
    with pytest.raises(ValueError):
        hist_kernel.launch_plan(0, 12, 2048, H100_SMS)
    with pytest.raises(ValueError, match="groups"):
        hist_kernel.launch_plan(16, 8 * hist_kernel.MAX_GROUPS + 1, 16,
                                H100_SMS)


def _emulate_hist(idx: np.ndarray, n_bins: int, plan, out: np.ndarray):
    """The kernel's dataflow in numpy: each CTA counts its slab into its
    own histogram; each cluster's rank r adds the sum of its peers'
    share r into ``out``."""
    t, c = idx.shape
    for y in range(plan.groups):
        c0 = y * plan.cells
        g = min(plan.cells, c - c0)
        for k in range(plan.clusters_t):
            hists = []
            for r in range(plan.cluster):
                x = k * plan.cluster + r
                slab = idx[x * plan.slice:(x + 1) * plan.slice, c0:c0 + g]
                h = np.zeros(g * n_bins, np.int64)
                for j in range(g):
                    b = slab[:, j][slab[:, j] >= 0]
                    np.add.at(h, j * n_bins + np.minimum(b, n_bins - 1), 1)
                hists.append(h)
            flat = out[c0:c0 + g].reshape(-1)
            for r in range(plan.cluster):
                lo, hi = hist_kernel.bin_share(r, plan.cluster, g, n_bins)
                flat[lo:hi] += sum(h[lo:hi] for h in hists)


@pytest.mark.parametrize("t,c,n_bins,n_sm", [
    (300, 5, 37, 132),      # one cell a CTA, 4 clusters of 8 along T
    (2000, 24, 16, 1),      # 8 cells a CTA, 16-byte loads, no cluster
    (3000, 21, 10, 1),      # 8 cells, a ragged last group, 4-byte loads
    (2000, 12, 16, 4),      # one cell a CTA, no cluster: all of T each
    (50, 8, 16, 132),       # 3 clusters of 8 along T, 3 steps a CTA
    (1, 3, 5, 132),
    (777, 37, 100, 132),
])
def test_hist_plan_emulated_equals_plain(t, c, n_bins, n_sm):
    rng = np.random.default_rng(t + c)
    idx = rng.integers(-1, 2 * n_bins, (t, c)).astype(np.int32)
    plan = hist_kernel.launch_plan(t, c, n_bins, n_sm)
    out = rng.integers(0, 50, (c, n_bins)).astype(np.float32)
    want = out + hist_accum_ref(torch.from_numpy(idx), n_bins=n_bins).numpy()
    _emulate_hist(idx, n_bins, plan, out)
    np.testing.assert_array_equal(out, want)
