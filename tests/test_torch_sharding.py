"""The port's sharding rules and meta-device specs
(``repro_torch.distributed.sharding``, ``repro_torch.launch.specs``,
``repro_torch.configs.base`` shapes) against the JAX package's, on the
CPU, for all ten architectures at their full size: the twin of
``tests/test_dryrun_integration.py::TestShardingRules`` and more.

Every port parameter's spec equals ``repro.distributed.sharding
.param_spec`` on its JAX leaf's path and shape (a repeated block's
tensor: the stacked leaf's spec without its leading ``None``), for
training (each arch's recipe) and inference (``_decode_ep_axes``, one
pod and two); every spec divides its dim at the production sizes (16 x
16, 2 x 16 x 16); the optimizer state's specs equal ``opt_shardings``'s;
``make_layout`` agrees for every ``cells(arch)`` x multi-pod, and
``cache_spec`` / ``batch_shardings`` at those layouts. JAX's functions
take an ``AbstractMesh`` of the production sizes, the port's a
``{axis: size}`` mapping. The specs of ``launch/specs.py`` (meta
tensors) have the shapes and dtypes of JAX's ``eval_shape``. All exact.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro_torch.configs import base
from repro_torch.distributed import sharding
from repro_torch.launch import specs
from repro_torch.models import lm

ARCHS = base.list_architectures()
SIZES = {False: {"data": 16, "model": 16},
         True: {"pod": 2, "data": 16, "model": 16}}


def abstract_mesh(multi_pod: bool) -> AbstractMesh:
    sizes = SIZES[multi_pod]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes),
                        axis_types=(AxisType.Auto,) * len(sizes))


def norm(spec) -> tuple:
    """A spec's entries as None or a tuple of axes (JAX writes a lone
    axis as its name)."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


def flat_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsh._path_str(p): leaf for p, leaf in flat}


_CACHE: dict = {}


def models(arch):
    """(jax cfg, port cfg, JAX param shapes by path, port meta model)."""
    if arch not in _CACHE:
        jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
        _CACHE[arch] = (jcfg, cfg, flat_paths(jspecs.param_specs(jcfg)),
                        specs.param_specs(cfg))
    return _CACHE[arch]


def jax_param_spec(jcfg, path, shape, **kw):
    return norm(jsh.param_spec(path, shape, jcfg, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_dtypes_equal_eval_shape(arch):
    _, _, jparams, meta = models(arch)
    leaves = sharding.jax_leaves(meta)
    params = dict(meta.named_parameters())
    assert sorted(leaf.path for leaf in leaves.values()) == sorted(jparams)
    for leaf in leaves.values():
        want = jparams[leaf.path]
        assert leaf.shape == tuple(want.shape), leaf.path
        for name in leaf.names:
            p = params[name]
            assert p.device.type == "meta"
            assert str(p.dtype).split(".")[-1] == str(want.dtype), name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "inference", "inference_pods"])
def test_param_specs_equal_jax(arch, mode):
    jcfg, cfg, _, meta = models(arch)
    inference = mode != "train"
    ep = (jsh._decode_ep_axes(jcfg, mode == "inference_pods") if inference
          else ("model",))
    assert ep == sharding._decode_ep_axes(cfg, mode == "inference_pods") \
        or not inference
    got = sharding.port_param_specs(meta, cfg, inference=inference,
                                    ep_axes=ep)
    for leaf in sharding.jax_leaves(meta).values():
        want = jax_param_spec(jcfg, leaf.path, leaf.shape,
                              inference=inference, ep_axes=ep)
        assert norm(sharding.param_spec(leaf.path, leaf.shape, cfg,
                                        inference=inference,
                                        ep_axes=ep)) == want
        for name in leaf.names:
            assert norm(got[name]) == (want[1:] if leaf.stacked else want), \
                (arch, mode, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide_at_production_sizes(arch):
    """The twin of TestShardingRules.test_param_specs_divisible_all_archs:
    every sharded dim divides at 2 x 16 x 16, and the spec's blocks
    tile the parameter."""
    jcfg, cfg, _, meta = models(arch)
    params = dict(meta.named_parameters())
    for inference in (False, True):
        ep = (sharding._decode_ep_axes(cfg, False) if inference
              else ("model",))
        got = sharding.port_param_specs(meta, cfg, inference=inference,
                                        ep_axes=ep)
        for name, spec in got.items():
            shape = params[name].shape
            assert len(spec) == len(shape)
            for d, axes in enumerate(norm(spec)):
                if axes is None:
                    continue
                size = int(np.prod([SIZES[True][a] for a in axes]))
                assert shape[d] % size == 0, (arch, name, spec, inference)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_jax_opt_shardings(arch):
    jcfg, cfg, _, meta = models(arch)
    jparams = jspecs.param_specs(jcfg)
    jopt = jspecs.opt_state_specs(jcfg, jparams)
    want = {k: norm(v.spec) for k, v in flat_paths(
        jsh.opt_shardings(jcfg, abstract_mesh(False), jopt,
                          jparams)).items()}
    opt_state = specs.opt_state_specs(cfg, meta)
    got = sharding.opt_specs(cfg, opt_state, meta)
    leaves = sharding.jax_leaves(meta)
    by_name = {n: leaf for leaf in leaves.values() for n in leaf.names}
    seen = set()
    for head, sub in got.items():
        for key, spec in sub.items():
            if cfg.optimizer == "adamw":   # keyed by parameter
                leaf = by_name[key]
                w = want[f"{head}/{leaf.path}"]
                w = w[1:] if leaf.stacked else w
                seen.add(f"{head}/{leaf.path}")
            else:                          # keyed by JAX leaf
                w = want[f"{head}/{leaves[key].path}"]
                seen.add(f"{head}/{leaves[key].path}")
            assert norm(spec) == w, (arch, head, key)
            assert len(spec) == opt_state[head][key].dim()
    assert seen == set(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_for_every_cell(arch):
    """The twin of TestShardingRules.test_layouts_defined_for_all_cells,
    and the layouts equal JAX's."""
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    assert [c.name for c in base.cells(arch)] == \
        [c.name for c in jbase.cells(arch)]
    assert {k: tuple(v.__dict__.values()) for k, v in base.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in jbase.SHAPES.items()}
    for shape in base.cells(arch):
        for mp in (False, True):
            lay = sharding.make_layout(cfg, shape.kind, mp,
                                       shape.global_batch)
            jlay = jsh.make_layout(jcfg, shape.kind, mp, shape.global_batch)
            assert lay.__dict__ == jlay.__dict__, (arch, shape.name, mp)
            if shape.kind == "decode":
                assert lay.kv_seq is not None


def test_decode_ep_axes():
    ds = base.get_config("deepseek-v3-671b")
    assert sharding._decode_ep_axes(ds, False) == ("model", "data")
    gr = base.get_config("granite-moe-3b-a800m")
    assert sharding._decode_ep_axes(gr, False) == ("model",)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch):
    """``batch_shardings`` on every cell's batch and ``cache_spec`` on
    every decode cell's cache (the port's per-layer cache read through
    the JAX cache's paths), at one pod and two; the specs' shapes and
    dtypes equal JAX's ``eval_shape``."""
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    for shape in base.cells(arch):
        for mp in (False, True):
            lay = sharding.make_layout(cfg, shape.kind, mp,
                                       shape.global_batch)
            jlay = jsh.make_layout(jcfg, shape.kind, mp, shape.global_batch)
            amesh = abstract_mesh(mp)
            if shape.kind != "decode":
                batch = specs.batch_specs(cfg, shape)
                jbatch = jspecs.batch_specs(jcfg, shape)
                assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                        for k, v in batch.items()} == \
                    {k: (tuple(v.shape), str(v.dtype))
                     for k, v in jbatch.items()}
                want = jsh.batch_shardings(jcfg, amesh, jlay, jbatch)
                got = sharding.batch_shardings(cfg, SIZES[mp], lay, batch)
                assert {k: norm(v) for k, v in got.items()} == \
                    {k: norm(v.spec) for k, v in want.items()}
                continue
            dspec = specs.decode_specs(cfg, shape)
            jd = jspecs.decode_specs(jcfg, shape)
            assert tuple(dspec["tokens"].shape) == tuple(jd["tokens"].shape)
            jcache = flat_paths(jd["cache"])
            got = sharding.cache_specs(cfg, SIZES[mp], lay, dspec["cache"])
            paths = sharding.cache_layer_paths(cfg)
            seen = set()

            def walk(layer, lspecs, prefix, stacked):
                for leaf, t in layer.items():
                    path = f"{prefix}/{leaf}"
                    if isinstance(t, dict):
                        walk(t, lspecs[leaf], path, stacked)
                        continue
                    want_leaf = jcache[path]
                    wshape = tuple(want_leaf.shape)
                    assert tuple(t.shape) == (wshape[1:] if stacked
                                              else wshape), path
                    assert str(t.dtype).split(".")[-1] == \
                        str(want_leaf.dtype), path
                    w = norm(jsh.cache_spec(path, wshape, jcfg, amesh, jlay))
                    assert norm(lspecs[leaf]) == (w[1:] if stacked else w), \
                        (arch, path, mp)
                    seen.add(path)

            for (prefix, stacked), layer, lspecs in zip(paths, dspec["cache"],
                                                        got):
                walk(layer, lspecs, prefix, stacked)
            assert seen == set(jcache)


def test_spec_placements_and_blocks():
    """``to_placements`` on a (data, model) mesh and ``local_shard``'s
    blocks, major to minor, on a one-rank mesh's arithmetic."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # the attributes the two read
        mesh_dim_names = ("data", "model")
        mesh = torch.arange(4).reshape(2, 2)

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    assert sharding.to_placements((None, ("data", "model")), Mesh([0, 0])) \
        == (Shard(1), Shard(1))
    assert sharding.to_placements(("model", None), Mesh([0, 0])) == \
        (Replicate(), Shard(0))
    with pytest.raises(ValueError):
        sharding.to_placements((("model", "data"),), Mesh([0, 0]))
    x = torch.arange(32).reshape(8, 4)
    for d in range(2):
        for m in range(2):
            blk = sharding.local_shard(x, (("data", "model"), None),
                                       Mesh([d, m]))
            assert torch.equal(blk, x[2 * (2 * d + m):2 * (2 * d + m) + 2])
            blk = sharding.local_shard(x, ("data", "model"), Mesh([d, m]))
            assert torch.equal(blk, x[4 * d:4 * d + 4, 2 * m:2 * m + 2])
    with pytest.raises(ValueError):
        sharding.local_shard(torch.zeros(3, 4), ("data", None), Mesh([0, 0]))


def test_specs_stand_ins_cost_nothing():
    """deepseek-v3-671b's parameters and optimizer state on the meta
    device: 671B parameters, no storage."""
    cfg = base.get_config("deepseek-v3-671b")
    meta = specs.param_specs(cfg)
    opt = specs.opt_state_specs(cfg, meta)
    assert lm.counted_params(meta) == cfg.param_count
    for sub in opt.values():
        for t in sub.values():
            assert t.device.type == "meta"
    jcfg = jbase.get_config("deepseek-v3-671b")
    jopt = flat_paths(jspecs.opt_state_specs(jcfg,
                                             jspecs.param_specs(jcfg)))
    leaves = sharding.jax_leaves(meta)
    for head, sub in opt.items():
        for key, t in sub.items():
            want = jopt[f"{head}/{leaves[key].path}"]
            assert tuple(t.shape) == tuple(want.shape)
            assert str(t.dtype).split(".")[-1] == str(want.dtype)
