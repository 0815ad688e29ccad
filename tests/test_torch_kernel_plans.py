"""Host-side plans of the port's CUDA kernels, on the CPU: the split plan
of ``decode_attention`` (from the cache's shape and the card's SM count)
and the per-source ``nvcc`` flags. The kernels themselves run only on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import kernel as da_kernel

H100_SMS = 132


def _cu_constant(source: str, name: str) -> int:
    text = (build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\w+);", text)
    assert m, name
    value = m.group(1)
    return int(value) if value.isdigit() else _cu_constant(source, value)


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
    assert ("-lcuda" in flags) == (name == "flash_attention")
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
