"""PyTorch port of the ``repro`` reproduction of "Low latency via redundancy".

The JAX package ``repro`` is the reference; this package runs on an
NVIDIA H100 through hand-written CUDA kernels:

  * the sweep engine (``core.queueing.run``) and threshold estimators
    (``core.threshold``), through ``kernels.cell_update`` and
    ``kernels.hist_sketch``, on one device or sharded over a ``"cells"``
    mesh of slots in one process or several (``launch.mesh``,
    ``distributed.sweep_shard``, ``distributed.multihost``);
  * hedged LM serving of gemma2-2b, mamba2-370m and recurrentgemma-9b
    (``launch.serve``: ``serving.engine`` replicas behind
    ``serving.scheduler``, the model in ``models``), through
    ``kernels.flash_attention`` (prefill), ``kernels.decode_attention``
    (decode), ``kernels.ssd_scan`` and ``kernels.rglru_scan``;
  * adaptive hedged serving (``serving.service``'s
    ``BatchedHedgedService`` with ``serving.controller``'s
    ``AdaptiveController`` on a ``threshold.policy_table``, telemetry in
    ``serving.metrics``, trace replay in ``serving.replay``, fault
    injection in ``serving.faults``; ``examples.serve_hedged``);
  * the paper's empirical systems (``core.storage_sim``, ``core.dns``,
    ``core.netsim`` and the TCP model of ``core.analytic``), its
    figures and the benchmarks beside them (``bench``: ``python -m
    repro_torch.bench.run``), the engine ones through
    ``kernels.cell_update``; runnable examples in ``examples``.

It imports torch and numpy only — never JAX, and nothing of ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch path, which is what the CPU
tests do. Asking for CUDA on a machine without it raises.
"""
from repro_torch import interop  # noqa: F401
from repro_torch.core import (analytic, cellplan, chunkflow,  # noqa: F401
                              distributions, dns, netsim, queueing, scenario,
                              storage_sim, threshold)
from repro_torch.kernels.cell_update import ops as cell_update_ops  # noqa: F401
from repro_torch.kernels.hist_sketch import ops as hist_sketch_ops  # noqa: F401
