"""The port's decode-attention op against the JAX package, on the CPU.

The same numpy inputs go through JAX ``decode_attention_ref``, the Pallas
kernel in interpret mode and the port's plain version, for a dense cache
and a wrapped ring buffer, at the shapes of ``tests/test_kernels.py``.
Tolerances are those of ``tests/test_kernels.py``: 2e-3 for float32,
2e-2 for bf16. The CUDA kernels are held against the plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jda_ops
from repro.kernels.decode_attention import ref as jda_ref
from repro_torch import interop
from repro_torch.kernels.decode_attention import ops as da_ops

DTYPES = {"float32": (jnp.float32, 2e-3), "bfloat16": (jnp.bfloat16, 2e-2)}


def inputs(seed, b, length, h, kv, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    jdt, tol = DTYPES[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, 1, h, hd), (b, length, kv, hd),
                          (b, length, kv, hd))]
    jx = [jnp.asarray(a, dtype=jdt) for a in arrs]
    return jx, [interop.to_tensor(np.asarray(a), "cpu") for a in jx], tol


def ring_slots(length, pos):
    """Slot positions of a ring of ``length`` holding positions up to
    ``pos`` (wrapped: slot s holds the latest position = s mod length)."""
    return np.asarray([pos - ((pos - s) % length) for s in range(length)],
                      np.int32)


def check(q, k, v, tq, tk, tv, slots, pos, tol, **kw):
    port = da_ops.decode_attention(tq, tk, tv, interop.to_tensor(slots, "cpu"),
                                   pos, **kw)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    got = port.to(torch.float32).numpy()
    js = jnp.asarray(slots)
    for ref in (jda_ref.decode_attention_ref(q, k, v, js, jnp.int32(pos), **kw),
                jda_ops.decode_attention(q, k, v, js, jnp.int32(pos),
                                         interpret=True, **kw)):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    # (L, H, KV, hd, pos)
    (64, 4, 2, 32, 40),
    (128, 8, 8, 64, 127),
    (96, 4, 1, 16, 5),
])
def test_dense_cache(shape, dtype):
    length, h, kv, hd, pos = shape
    (q, k, v), (tq, tk, tv), tol = inputs(0, 2, length, h, kv, hd, dtype)
    slots = np.where(np.arange(length) <= pos, np.arange(length),
                     -1).astype(np.int32)
    check(q, k, v, tq, tk, tv, slots, pos, tol, softcap=50.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [32, 20])
def test_ring_buffer_window(window, dtype):
    # ring cache of 32 slots with wrapped positions (14..45); a window
    # shorter than the ring masks its oldest slots too
    w, h, kv, hd, pos = 32, 4, 2, 16, 45
    (q, k, v), (tq, tk, tv), tol = inputs(1, 1, w, h, kv, hd, dtype)
    check(q, k, v, tq, tk, tv, ring_slots(w, pos), pos, tol, window=window)


def test_slots_ahead_of_pos_are_masked():
    # the kernel's validity includes slot_pos <= pos (kernel.py:47-49)
    (q, k, v), (tq, tk, tv), tol = inputs(2, 1, 16, 2, 1, 16)
    slots = np.arange(16, dtype=np.int32)
    check(q, k, v, tq, tk, tv, slots, 9, tol, softcap=50.0)


def test_kernel_on_rejects_cpu_tensors():
    _, (tq, tk, tv), _ = inputs(3, 1, 16, 2, 1, 16, "bfloat16")
    slots = torch.arange(16, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        da_ops.decode_attention(tq, tk, tv, slots, 15, kernel="on")
