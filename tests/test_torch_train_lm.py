"""The port's training loss (``repro_torch.models.lm.loss_fn`` over
``forward_hidden``, ``layers.chunked_cross_entropy``, the MTP loss)
against the JAX package's ``lm.loss_fn`` and ``jax.grad``, on the CPU,
for all ten smoke architectures: the twins of ``test_models_smoke.py``'s
loss and grad cases, on JAX's weights carried into the port bit for bit
and one numpy batch.

Tolerances, measured on these inputs:
  * Loss: within ``LOSS_RTOL`` = 1e-3 of the JAX loss. JAX's own two
    programs for the same loss differ by up to 5.4e-4 of it (mamba2-370m,
    jit against op by op; granite 2.5e-4 between ``impl="ref"`` and
    ``"pallas"``); the port differs by up to 3.7e-4 (mamba2-370m).
  * Grads: per parameter, the largest |port - JAX| over the largest
    |JAX| of that parameter; its worst over the model within twice the
    port's own bf16 noise floor, the same measure between the port's
    bf16 model and its float32 copy (``.float()``) — the rule of
    ``tests/test_torch_recurrent_lm.py`` for logits. Measured: the port
    sits at 0.72 (command-r-35b) to 1.49 (musicgen-large) times that
    floor, which is 0.012 to 0.13 of a leaf's largest gradient (0.13 for
    mamba2-370m's ``a_log``).

MoE models replay JAX's expert choices (recorded with
``jax.debug.callback``; ``tests/test_torch_lm_families.py``): without it
a near-tie flipped by a bf16 ulp moves loss and grads past any
tolerance. JAX's gradient program routes each rematerialised MoE layer
twice, forward and recompute, with the same choices; the port's replay
hands a recomputed call (the same input, bit for bit) the choice its
forward took.
"""
import contextlib
import copy
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs import get_smoke_config, list_architectures
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.models import layers, lm, moe

ARCHS = list_architectures()
BATCH, SEQ = 2, 32
LOSS_RTOL = 1e-3
GRAD_FLOOR_MULT = 2.0


def batch_np(cfg, seed=1, batch=BATCH, seq=SEQ):
    """Token ids (B, S+1) — audio (B, S+1, K) — and, for a VLM, float32
    patches (B, P, E), from numpy."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq + 1) + ((cfg.n_codebooks,) if cfg.family == "audio"
                                else ())
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.patch_stub is not None:
        out["patches"] = rng.standard_normal(
            (batch, cfg.patch_stub.n_patches,
             cfg.patch_stub.embed_dim)).astype(np.float32)
    return out


@contextlib.contextmanager
def jax_routes_recorded(record: list):
    orig = jmoe.route

    def route(router_w, xt, cfg):
        out = orig(router_w, xt, cfg)
        jax.debug.callback(lambda idx: record.append(np.asarray(idx)),
                           out[0], ordered=True)
        return out

    jmoe.route = route
    try:
        yield
    finally:
        jmoe.route = orig


@contextlib.contextmanager
def port_routes_replayed(record: list, agree: list):
    """Each ``moe.route`` call on a new input takes the next recorded
    choice; a call on an input seen before (the recompute of a
    rematerialised repeat, bit for bit the same) takes the choice that
    input took. ``agree`` collects (matching, total) of the port's own
    choices against the replayed ones."""
    orig = moe.route
    queue = list(record)
    taken: dict = {}

    def route(router_w, xt, cfg):
        key = xt.detach().contiguous().view(-1).view(torch.uint8).numpy()
        key = (tuple(xt.shape), key.tobytes())
        if key not in taken:
            with torch.no_grad():  # the recompute saves what this did
                own = orig(router_w, xt, cfg)[0]
            taken[key] = torch.from_numpy(queue.pop(0).astype(np.int64))
            agree.append((int((own == taken[key]).sum()), own.numel()))
        idx = taken[key]
        logits = moe.router_logits(router_w, xt, cfg)
        return (idx, *moe.combine(logits, idx, cfg))

    moe.route = route
    try:
        yield len(queue)
    finally:
        moe.route = orig


def carried(arch, seed=0):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(seed), jcfg))
    model = lm.init(torch.Generator("cpu").manual_seed(seed), cfg)
    model.load_state_dict(interop.lm_params_from_numpy(params, cfg, "cpu"),
                          strict=True, assign=True)
    return jcfg, cfg, params, model.requires_grad_(True)


def port_loss_grads(model, batch, record=None, agree=None):
    ctx = (port_routes_replayed(record, agree) if record is not None
           else contextlib.nullcontext())
    for p in model.parameters():
        p.grad = None
    with ctx:
        total, metrics = lm.loss_fn(model, batch)
        total.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float()
             for n, p in model.named_parameters()}
    return float(total.detach()), metrics, grads


def worst_rel(got: dict, want: dict) -> tuple[float, str]:
    """The largest, over parameters, of max |got - want| / max |want|."""
    out = []
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        out.append((err / scale if scale else (0.0 if err == 0 else
                                               float("inf")), name))
    return max(out)


_RUNS: dict = {}


def runs(arch):
    """Per arch, once: JAX's loss and grads (numpy, as the port's names),
    the port's bf16 and float32 losses and grads, MoE agreement."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, cfg, params, model = carried(arch)
    bn = batch_np(cfg)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    record: list = []
    ctx = jax_routes_recorded(record) if cfg.moe else \
        contextlib.nullcontext()
    with ctx:
        (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(params, jb)
        jax.effects_barrier()
    jgrads = {k: v.float() for k, v in interop.lm_params_from_numpy(
        jax.device_get(jgrads), cfg, "cpu").items()}
    tb = {k: torch.from_numpy(v) for k, v in bn.items()}
    n_moe = sum(lm._mixer_mlp(k)[1] == "moe" for k in cfg.layer_kinds)
    fwd = record[:n_moe] if cfg.moe else None
    agree: list = []
    loss, metrics, grads = port_loss_grads(model, tb, fwd, agree)
    loss32, _, grads32 = port_loss_grads(copy.deepcopy(model).float(), tb,
                                         fwd, [])
    out = dict(cfg=cfg, record=record, n_moe=n_moe, agree=agree,
               jloss=float(jtotal), jmetrics=jax.device_get(jmetrics),
               jgrads=jgrads, loss=loss, metrics=metrics, grads=grads,
               loss32=loss32, grads32=grads32)
    _RUNS[arch] = out
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    r = runs(arch)
    assert np.isfinite(r["loss"]) and r["metrics"]["loss"] > 0.0
    assert abs(r["loss"] - r["jloss"]) <= LOSS_RTOL * abs(r["jloss"]), \
        (arch, r["loss"], r["jloss"])
    for key in ("loss", "aux_loss", "mtp_loss"):
        assert (key in r["metrics"]) == (key in r["jmetrics"])
        if key in r["metrics"]:
            want = float(r["jmetrics"][key])
            assert abs(float(r["metrics"][key]) - want) <= \
                LOSS_RTOL * max(abs(want), 1e-3), (arch, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_within_the_bf16_floor(arch):
    r = runs(arch)
    assert all(bool(torch.isfinite(g).all()) for g in r["grads"].values())
    assert any(float(g.abs().max()) > 0 for g in r["grads"].values())
    assert set(r["grads"]) == set(r["jgrads"])
    err, name = worst_rel(r["grads"], r["jgrads"])
    floor, fname = worst_rel(r["grads32"], r["grads"])
    assert err <= GRAD_FLOOR_MULT * floor, (arch, err, name, floor, fname)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_moe_routes_replayed_forward_then_recompute(arch):
    """JAX's gradient program routes the MoE layers forward, then again
    on recompute, with the same choices; the port's own choices agree
    with JAX's at most tokens (measured: 0.99 and 1.0)."""
    r = runs(arch)
    rec, n = r["record"], r["n_moe"]
    assert n > 0 and len(rec) >= n
    for again in rec[n:]:
        assert any(np.array_equal(again, first) for first in rec[:n])
    agree = sum(a for a, _ in r["agree"]) / sum(t for _, t in r["agree"])
    assert len(r["agree"]) == n and agree >= 0.95


def test_chunked_cross_entropy_matches_jax_and_its_grads():
    """Padded vocabulary columns, a mask and a final softcap, chunk 8 of
    32 positions, float32 inputs: loss and both grads within float32
    rounding of JAX's, and the same with one chunk."""
    rng = np.random.default_rng(3)
    v, d, b, s = 40, 16, 2, 32
    table = rng.standard_normal((v, d)).astype(np.float32)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    tgt = rng.integers(0, 37, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)

    def jloss(t, x, chunk):
        return jlayers.chunked_cross_entropy(t, x, jnp.asarray(tgt),
                                             jnp.asarray(mask), chunk=chunk,
                                             final_cap=30.0, n_valid=37)

    for chunk in (8, 32):
        jl, (jgt, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(table), jnp.asarray(h), chunk)
        t = torch.from_numpy(table).requires_grad_(True)
        x = torch.from_numpy(h).requires_grad_(True)
        loss = layers.chunked_cross_entropy(
            t, x, torch.from_numpy(tgt), torch.from_numpy(mask), chunk=chunk,
            final_cap=30.0, n_valid=37)
        loss.backward()
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgh),
                                   rtol=1e-5, atol=1e-6)
        assert float(t.grad[37:].abs().max()) == 0.0  # padded rows


def test_chunked_cross_entropy_recomputes_each_chunk(monkeypatch):
    """With grad enabled each chunk's logits are made twice (forward,
    then recompute in backward), one chunk at a time; under no_grad
    once."""
    calls = []
    orig = layers.logits_from_hidden

    def counted(table, h, cap=None):
        calls.append(tuple(h.shape))
        return orig(table, h, cap)

    monkeypatch.setattr(layers, "logits_from_hidden", counted)
    t = torch.randn(24, 8, requires_grad=True)
    x = torch.randn(1, 16, 8, requires_grad=True)
    tgt = torch.randint(0, 24, (1, 16))
    layers.chunked_cross_entropy(t, x, tgt, chunk=4).backward()
    assert calls == [(1, 4, 8)] * 8
    calls.clear()
    with torch.no_grad():
        layers.chunked_cross_entropy(t, x, tgt, chunk=4)
    assert calls == [(1, 4, 8)] * 4


def test_remat_gives_the_grads_of_no_remat():
    """The gemma2-2b smoke model's loss and grads with each repeat
    recomputed in backward equal those without remat bit for bit:
    recompute runs the same operations on the same inputs. The JAX
    package's other policy, ``"dots"``, which no config uses, raises."""
    _, cfg, _, model = carried("gemma2-2b")
    tb = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    model.cfg = dataclasses.replace(cfg, remat=False)
    want_loss, _, want = port_loss_grads(model, tb)
    model.cfg = cfg
    loss, _, got = port_loss_grads(model, tb)
    assert loss == want_loss
    for name in want:
        assert torch.equal(got[name], want[name]), name
    model.cfg = dataclasses.replace(cfg, remat_policy="dots")
    with pytest.raises(ValueError, match="remat_policy"):
        lm.loss_fn(model, tb)


def test_forward_hidden_keeps_prefix_and_suffix_out_of_remat(monkeypatch):
    """Only the repeats of ``cfg.pattern`` go through the checkpoint, one
    call a repeat: deepseek's smoke prefix layer runs plain."""
    _, cfg, _, model = carried("deepseek-v3-671b")
    calls = []
    orig = lm.ckpt_utils.checkpoint

    def counted(fn, *args, **kw):
        calls.append(len(args[1]))
        return orig(fn, *args, **kw)

    monkeypatch.setattr(lm.ckpt_utils, "checkpoint", counted)
    x = torch.randn(1, 8, cfg.d_model, dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)[None]
    lm.forward_hidden(model, x, pos)
    assert calls == [len(cfg.pattern)] * cfg.repeats
    assert len(cfg.prefix) > 0


def test_leaf_groups_cover_every_parameter_once():
    """``lm.leaf_groups`` names every JAX leaf (the stacked repeats as
    lists in repeat order) and every port parameter once."""
    jcfg, cfg, params, model = carried("deepseek-v3-671b")
    groups = lm.leaf_groups(model)
    jax_paths = {p for p, _ in interop._flat(params)}
    assert set(groups) == jax_paths
    names = [n for g in groups.values()
             for n in ([g] if isinstance(g, str) else g)]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    for path, leaf in interop._flat(params):
        g = groups[path]
        shape = np.shape(leaf)
        if isinstance(g, list):
            assert shape[0] == len(g) == cfg.repeats
            shape = shape[1:]
        first = g if isinstance(g, str) else g[0]
        assert tuple(dict(model.named_parameters())[first].shape) == shape


def test_ssd_plain_backward_is_finite_past_float32_range():
    """A full chunk of 256 steps at dt = 0.7 (mamba2-370m's a = -1):
    ``exp(cum_q - cum_s)`` overflows above the diagonal. Its gradient is
    zero there, not 0 x inf = NaN; the forward is unchanged."""
    torch.manual_seed(0)
    xc = torch.randn(1, 1, 256, 2, 4, requires_grad=True)
    bc, cc = torch.randn(1, 1, 256, 8), torch.randn(1, 1, 256, 8)
    dt = torch.full((1, 1, 256, 2), 0.7, requires_grad=True)
    cum = torch.cumsum(-dt, dim=2)
    y, states = ssd_intra_chunk_ref(xc, bc, cc, dt, cum)
    (y.sum() + states.sum()).backward()
    assert bool(torch.isfinite(dt.grad).all())
    assert bool(torch.isfinite(xc.grad).all())
    rel = cum.detach()[:, :, :, None, :] - cum.detach()[:, :, None, :, :]
    mask = torch.ones(256, 256, dtype=torch.bool).tril()[None, None, :, :,
                                                          None]
    want = torch.where(mask, torch.exp(rel), torch.zeros(()))
    assert bool(torch.isinf(torch.exp(rel)).any())  # the case is real
    got = torch.exp(rel.masked_fill(~mask, -torch.inf))
    assert torch.equal(got, want)


def test_kernel_refuses_grad_requiring_inputs(monkeypatch):
    """A call that would launch a kernel on an input that requires grad
    raises (the kernels have no backward), under grad only; ``"off"``
    and ``torch.no_grad()`` pass. (The CPU cannot launch a kernel:
    ``resolve`` is made to answer ``"on"``; the card test launches.)"""
    monkeypatch.setattr(dispatch, "resolve", lambda kernel, device:
                        "off" if kernel == "off" else "on")
    q = torch.randn(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        dispatch.use_kernel("auto", q)
    with pytest.raises(RuntimeError, match="no backward"):
        dispatch.use_kernel("on", q.detach(), q)
    assert dispatch.use_kernel("auto", q.detach()) is True
    assert dispatch.use_kernel("off", q) is False
    with torch.no_grad():
        assert dispatch.use_kernel("on", q) is True


def test_training_modules_import_no_jax():
    """The port's training, checkpoint, data and launcher modules (and
    the train_100m example) import neither ``jax`` nor ``repro``."""
    code = ("import sys\n"
            "import repro_torch.training.train_loop, "
            "repro_torch.training.grad_agg, repro_torch.checkpoint.ckpt, "
            "repro_torch.data.pipeline, repro_torch.launch.train, "
            "repro_torch.examples.train_100m\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
