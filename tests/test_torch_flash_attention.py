"""The port's flash-attention op against the JAX package, on the CPU.

The same numpy inputs go through JAX ``flash_attention_ref``, the Pallas
kernel in interpret mode (``fa_ops.flash_attention(interpret=True)``) and
the port's plain version (``repro_torch.kernels.flash_attention``), at the
shapes and dtypes of ``tests/test_kernels.py``. Tolerances are those of
``tests/test_kernels.py``: 2e-3 for float32, 2e-2 for bf16 (the paths
round probabilities to bf16 at different points). The CUDA kernel itself
is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import attention as jattn
from repro_torch import interop
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(seed, b, s, h, kv, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    jdt, tdt, tol = DTYPES[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    jx = [jnp.asarray(a, dtype=jdt) for a in arrs]
    tx = [interop.to_tensor(np.asarray(a), "cpu") for a in jx]
    assert all(t.dtype == tdt for t in tx)
    return jx, tx, tol


def close(port, *refs, tol):
    got = port.to(torch.float32).numpy()
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    # (S, H, KV, hd)
    (64, 4, 2, 32),    # GQA
    (128, 2, 2, 64),   # MHA
    (96, 8, 1, 16),    # MQA, non-pow2 seq
    (256, 4, 4, 128),  # large block
])
def test_plain_matches_reference_and_pallas(shape, dtype):
    s, h, kv, hd = shape
    (q, k, v), (tq, tk, tv), tol = inputs(0, 2, s, h, kv, hd, dtype)
    port = fa_ops.flash_attention(tq, tk, tv)
    assert port.dtype == tq.dtype and tuple(port.shape) == (2, s, h, hd)
    close(port, jfa_ref.flash_attention_ref(q, k, v),
          jfa_ops.flash_attention(q, k, v, interpret=True), tol=tol)


@pytest.mark.parametrize("window", [8, 32])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_window_and_softcap(window, softcap):
    (q, k, v), (tq, tk, tv), tol = inputs(1, 1, 64, 4, 2, 32)
    port = fa_ops.flash_attention(tq, tk, tv, window=window, softcap=softcap)
    close(port,
          jfa_ref.flash_attention_ref(q, k, v, window=window,
                                      softcap=softcap),
          jfa_ops.flash_attention(q, k, v, window=window, softcap=softcap,
                                  interpret=True), tol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sequence_no_block_divides(dtype):
    # S = 37 is prime: the JAX wrapper falls back to blocks of 1; the port
    # has no block search (its kernel masks tile edges)
    (q, k, v), (tq, tk, tv), tol = inputs(2, 1, 37, 4, 2, 32, dtype)
    for window, cap in ((None, None), (16, 50.0)):
        port = fa_ops.flash_attention(tq, tk, tv, window=window, softcap=cap)
        close(port, jfa_ref.flash_attention_ref(q, k, v, window=window,
                                                softcap=cap), tol=tol)


def test_matches_model_reference_path():
    # the plain version is the JAX model's own _sdpa arithmetic
    (q, k, v), (tq, tk, tv), tol = inputs(3, 2, 32, 4, 2, 16)
    for window in (None, 8):
        expect = jattn._sdpa(q, k, v, jattn.causal_mask(32, window), 50.0)
        close(flash_attention_ref(tq, tk, tv, window=window, softcap=50.0),
              expect, tol=tol)


def test_kernel_on_rejects_cpu_tensors():
    _, (tq, tk, tv), _ = inputs(4, 1, 16, 2, 1, 16, "bfloat16")
    with pytest.raises(RuntimeError, match="CUDA"):
        fa_ops.flash_attention(tq, tk, tv, kernel="on")
    with pytest.raises(ValueError, match="kernel must be"):
        fa_ops.flash_attention(tq, tk, tv, kernel="pallas")
