"""The port's MoE and MLA layers (``repro_torch.models.moe``/``mla``)
against the JAX package's, on the CPU: twins of
``tests/test_model_internals.py``'s ``TestMoEUnit`` and ``TestMLAUnit``
on the port's own weights, and the two packages on the same weights
(carried from JAX bit for bit) and inputs.

Tolerances: float32 weights and inputs 1e-5 (the same arithmetic, summed
in other orders); bf16 MoE 0.05 (two bf16 roundings of outputs of order
one, 2**-7 each), bf16 MLA 0.05 likewise; the twins keep the JAX tests'
2e-3. Expert choices and capacity drops must be equal, not close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode as jdec
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode, layers, lm, mla, moe

CFG = MoEConfig(n_experts=10, top_k=2, d_expert=16, capacity_factor=8.0)
MLA_CFG = dict(q_lora_rank=16, kv_lora_rank=12, qk_nope_dim=8,
               qk_rope_dim=4, v_head_dim=8)
F32_TOL = 1e-5
BF16_TOL = 0.05


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from flat(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def carry(module, tree):
    """Load the JAX tree's leaves (numpy) into ``module`` bit for bit."""
    module.load_state_dict({path: interop.to_tensor(np.asarray(leaf), "cpu")
                            for path, leaf in flat(jax.device_get(tree))},
                           strict=True, assign=True)
    return module


def port_moe(cfg=CFG, d=8, gated=True, dtype=torch.float32, seed=0):
    return moe.init_moe(torch.Generator().manual_seed(seed), d, cfg, gated,
                        dtype=dtype)


def randn(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


class TestMoETwins:
    """``TestMoEUnit`` of the JAX package, on the port's own weights."""

    def test_padded_experts_never_routed(self):
        p = port_moe()
        idx, w, mask, aux = moe.route(p.router.w, randn(1, 40, 8), CFG)
        assert CFG.padded_experts == 16
        assert int(idx.max()) < CFG.n_experts  # 10..15 are padding
        assert float(mask[:, CFG.n_experts:].sum()) == 0.0

    def test_local_slice_sums_to_full(self):
        """The per-slice outputs over disjoint expert ranges, less the
        shared experts each slice adds, sum to the full MoE."""
        cfg = MoEConfig(n_experts=10, top_k=2, d_expert=16, n_shared=1,
                        d_shared=16, capacity_factor=8.0)
        p = port_moe(cfg)
        x = randn(2, 4, 6, 8)
        full, _ = moe.moe_mlp(p, x, cfg, "silu")
        shared = layers.mlp(p.shared, x, "silu")
        part = torch.zeros_like(full)
        for start in range(0, cfg.padded_experts, 4):
            sl = moe.MoE(p.router, p.w_up[start:start + 4],
                         p.w_out[start:start + 4], p.w_gate[start:start + 4],
                         p.shared)
            y, _ = moe.moe_mlp(sl, x, cfg, "silu", e_start=start, e_local=4)
            part = part + (y - shared)
        part = part + shared
        torch.testing.assert_close(part, full, rtol=2e-3, atol=2e-3)

    def test_combine_weights_normalized(self):
        p = port_moe()
        _, w, _, _ = moe.route(p.router.w, randn(3, 16, 8), CFG)
        torch.testing.assert_close(w.sum(-1), torch.ones(16), rtol=1e-5,
                                   atol=0)

    def test_capacity_drops_tokens(self):
        cfg = MoEConfig(n_experts=4, top_k=1, d_expert=8,
                        capacity_factor=1.0)
        p = port_moe(cfg, gated=False)
        x = randn(4, 32, 8)
        y_small, _ = moe.moe_mlp(p, x, cfg, "silu", capacity=1)
        y_big, _ = moe.moe_mlp(p, x, cfg, "silu", capacity=32)
        # with capacity 1 most tokens are dropped -> many zero rows
        assert float((y_small == 0).all(-1).float().mean()) > 0.5
        assert float((y_big == 0).all(-1).float().mean()) < 0.2


def moe_pair(jcfg, d, gated, dtype, seed=0):
    """JAX ``init_moe`` params and the port's MoE carrying them."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = jmoe.init_moe(jax.random.PRNGKey(seed), d, jcfg, gated,
                           dtype=jdtype)
    cfg = MoEConfig(**{f: getattr(jcfg, f) for f in (
        "n_experts", "top_k", "d_expert", "n_shared", "d_shared",
        "first_dense", "capacity_factor", "aux_loss_weight")})
    return params, carry(port_moe(cfg, d, gated, dtype), params), cfg


class TestMoEAgainstJax:
    def test_route_orders_ties_as_lax_top_k(self):
        """Exact ties (duplicated router columns) pick the lower expert
        first in both packages, and every choice is equal."""
        cfg, jcfg = MoEConfig(6, 3, 4), JaxMoEConfig(6, 3, 4)
        w = np.random.default_rng(0).standard_normal((8, 16)).astype(
            np.float32)
        w[:, 3] = w[:, 1]
        w[:, 4] = w[:, 1]
        w[:, 5] = w[:, 0]
        x = np.random.default_rng(1).standard_normal((64, 8)).astype(
            np.float32)
        x[:16] = 0.0  # all-zero logits: every real expert tied
        idx, wts, mask, aux = moe.route(torch.from_numpy(w),
                                        torch.from_numpy(x), cfg)
        jidx, jwts, jmask, jaux = jmoe.route(jnp.asarray(w), jnp.asarray(x),
                                             jcfg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(idx[:16].numpy(),
                                      np.tile([0, 1, 2], (16, 1)))
        np.testing.assert_allclose(wts.numpy(), np.asarray(jwts),
                                   rtol=0, atol=F32_TOL)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert abs(float(aux) - float(jaux)) <= F32_TOL

    @pytest.mark.parametrize("capacity", [1, 3, None, 32])
    def test_capacity_drops_equal_jax(self, capacity):
        """Top-1 over 4 experts at capacity factor 1.0 (8 slots for 32
        tokens; and 1, 3, 32): the same tokens dropped, in the same
        cumsum order, and the same outputs."""
        jcfg = JaxMoEConfig(n_experts=4, top_k=1, d_expert=8,
                            capacity_factor=1.0)
        params, p, cfg = moe_pair(jcfg, 8, False, torch.float32)
        x = np.random.default_rng(4).standard_normal((32, 8)).astype(
            np.float32)
        y, aux = moe.moe_mlp(p, torch.from_numpy(x), cfg, "silu",
                             capacity=capacity)
        jy, jaux = jmoe.moe_mlp(params, jnp.asarray(x), jcfg, "silu",
                                capacity=capacity)
        jy = np.asarray(jy)
        dropped = (jy == 0).all(-1)
        if capacity in (1, 3, None):
            assert dropped.any()
        np.testing.assert_array_equal((y == 0).all(-1).numpy(), dropped)
        np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=F32_TOL)
        assert abs(float(aux) - float(jaux)) <= F32_TOL

    def test_moe_mlp_equals_jax_bf16_with_shared_expert(self):
        """deepseek's layout at a small size: top-2 of 8 experts with a
        shared expert, bf16 weights, 48 tokens at capacity factor 1.25
        (15 slots, so some drop), gated SiLU."""
        jcfg = JaxMoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                            d_shared=32)
        params, p, cfg = moe_pair(jcfg, 16, True, torch.bfloat16, seed=2)
        x = np.array(jax.random.normal(jax.random.PRNGKey(5), (3, 16, 16)),
                     np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        y, _ = moe.moe_mlp(p, torch.from_numpy(x).to(torch.bfloat16), cfg,
                           "silu")
        jy, _ = jmoe.moe_mlp(params, xb, jcfg, "silu")
        idx, _, mask, _ = moe.route(p.router.w, torch.from_numpy(
            np.array(xb, np.float32)).to(torch.bfloat16).reshape(-1, 16),
            cfg)
        jidx = jmoe.route(params["router"]["w"], xb.reshape(-1, 16), jcfg)[0]
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert moe.expert_capacity(48, cfg) == 15
        assert float(mask.sum(0).max()) > 15  # an expert drops tokens
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(jy, np.float32), rtol=0,
                                   atol=BF16_TOL)


def mla_pair(dtype, d=32, h=2, seed=0):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = jmla.init_mla(jax.random.PRNGKey(seed), d, h,
                           JaxMLAConfig(**MLA_CFG), dtype=jdtype)
    p = mla.init_mla(torch.Generator().manual_seed(seed), d, h,
                     MLAConfig(**MLA_CFG), dtype=dtype)
    return params, carry(p, params)


class TestMLA:
    def test_absorbed_decode_matches_expanded(self):
        """The absorbed decode equals the expanded attention on a
        one-token query (the JAX package's ``TestMLAUnit`` twin)."""
        cfg = MLAConfig(**MLA_CFG)
        d, h, s, b = 32, 2, 6, 2
        p = mla.init_mla(torch.Generator().manual_seed(0), d, h, cfg,
                         dtype=torch.float32)
        x = randn(1, b, s, d) * 0.5
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        y_full = mla.mla_attention(p, x, pos, cfg=cfg, rope_theta=10_000.0)
        cache = mla.init_mla_cache(b, s + 2, cfg, dtype=torch.float32)
        for t in range(s - 1):
            c_t, r_t = mla._latents(p, x[:, t:t + 1],
                                    torch.full((b, 1), t), cfg, 10_000.0,
                                    1e-6)
            cache["c_kv"][:, t] = c_t[:, 0]
            cache["k_rope"][:, t] = r_t[:, 0]
        y_dec, _ = mla.mla_decode(p, x[:, s - 1:s], cache, s - 1, cfg=cfg,
                                  rope_theta=10_000.0)
        torch.testing.assert_close(y_dec[:, 0], y_full[:, -1], rtol=2e-3,
                                   atol=2e-3)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_prefill_and_decode_equal_jax(self, dtype):
        """``mla_attention`` (expanded, with its latents) over 7 positions,
        then 3 absorbed decode steps on the latent cache, against JAX's
        on the same weights and inputs."""
        cfg, jcfg = MLAConfig(**MLA_CFG), JaxMLAConfig(**MLA_CFG)
        params, p = mla_pair(dtype)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        x = np.random.default_rng(6).standard_normal((1, 10, 32)).astype(
            np.float32) * 0.5
        xj = jnp.asarray(x, jdtype)
        xt = torch.from_numpy(x).to(dtype)
        s = 7
        pos = np.arange(s, dtype=np.int32)[None]
        jy, (jc, jr) = jmla.mla_attention(params, xj[:, :s], jnp.asarray(pos),
                                          n_heads=2, cfg=jcfg,
                                          rope_theta=10_000.0,
                                          return_kv=True)
        y, (c, r) = mla.mla_attention(p, xt[:, :s], torch.from_numpy(pos),
                                      cfg=cfg, rope_theta=10_000.0,
                                      return_kv=True)
        for got, want in ((y, jy), (c, jc), (r, jr)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32), rtol=0,
                                       atol=tol)
        cache = mla.mla_cache_from_latents(c, r, 12)
        jcache = {k: jnp.zeros((1, 12, v.shape[-1]), jnp.bfloat16
                               ).at[:, :s].set(v.astype(jnp.bfloat16))
                  for k, v in (("c_kv", jc), ("k_rope", jr))}
        for t in range(s, 10):
            y, cache = mla.mla_decode(p, xt[:, t:t + 1], cache, t, cfg=cfg,
                                      rope_theta=10_000.0)
            jy, jcache = jmla.mla_decode(params, xj[:, t:t + 1], jcache,
                                         jnp.int32(t), n_heads=2, cfg=jcfg,
                                         rope_theta=10_000.0)
            np.testing.assert_allclose(y.float().numpy(),
                                       np.asarray(jy, np.float32), rtol=0,
                                       atol=tol)
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[key].float().numpy(),
                                       np.asarray(jcache[key], np.float32),
                                       rtol=0, atol=BF16_TOL)

    def test_latent_cache_past_max_len_raises(self):
        cfg = MLAConfig(**MLA_CFG)
        _, p = mla_pair(torch.float32)
        cache = mla.init_mla_cache(1, 4, cfg, dtype=torch.float32)
        with pytest.raises(ValueError, match="max_len"):
            mla.mla_decode(p, randn(0, 1, 1, 32), cache, 4, cfg=cfg,
                           rope_theta=10_000.0)


def test_latent_cache_crosses_interop():
    """deepseek's smoke cache (one MLA prefix layer, three MLA-MoE layers
    stacked over repeats): JAX's ``init_cache`` equals the port's carried
    across, and the port's prefill cache crosses to a JAX-shaped tree and
    back bit for bit."""
    arch = "deepseek-v3-671b"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jc = jax.device_get(jdec.init_cache(jcfg, 1, 16))
    mine = decode.init_cache(cfg, 1, 16, "cpu")
    carried = interop.lm_cache_from_numpy(jc, cfg, "cpu")
    assert len(mine) == len(carried) == cfg.n_layers
    for a, b in zip(mine, carried):
        assert set(a) == set(b) == {"c_kv", "k_rope"}
        for key in a:
            assert torch.equal(a[key], b[key]), key
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
    model = lm.init(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(interop.lm_params_from_numpy(params, cfg, "cpu"),
                          strict=True, assign=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 9)))
    _, cache = decode.prefill(model, toks, 16)
    tree = interop.lm_cache_to_numpy(cache, cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(jc)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(jc)):
        assert got.shape == want.shape and got.dtype == want.dtype
    back = interop.lm_cache_from_numpy(tree, cfg, "cpu")
    for a, b in zip(cache, back):
        for key in a:
            assert torch.equal(a[key], b[key]), key
