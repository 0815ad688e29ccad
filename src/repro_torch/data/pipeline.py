"""Deterministic synthetic data pipeline with hedged prefetch.

A copy of ``repro.data.pipeline`` (numpy and threads; it imports no JAX),
with the port's configs: its batches are byte-equal to the JAX
package's for the same config, seed, shard and step.

Determinism contract: ``batch_at(step)`` is a pure function of
(seed, step, shard) — a restarted job consumes byte-identical data, which is
what makes checkpoint/resume bitwise-reproducible (tested).

Sources:
  * ``UniformSource`` — i.i.d. tokens (shape/perf testing).
  * ``MarkovSource`` — a fixed random bigram chain, so small models have
    learnable structure and examples show a falling loss.

Redundancy hook (the paper, applied to the input pipeline): the
``HedgedPrefetcher`` races k identical loader workers for the next batch and
takes the first to finish — masking slow/hung loader threads exactly the
way §2 masks slow servers. Batches are deterministic, so duplicates are
interchangeable by construction.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 64
    batch_size: int = 8          # per-shard batch
    seed: int = 0
    shard: int = 0
    num_shards: int = 1


class UniformSource:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        d = self.dcfg
        rng = np.random.Generator(np.random.Philox(
            key=d.seed, counter=[step, d.shard, 0, 0]))
        shape: tuple[int, ...] = (d.batch_size, d.seq_len + 1)
        if self.cfg.family == "audio":
            shape = (*shape, self.cfg.n_codebooks)
        batch = {"tokens": rng.integers(0, self.cfg.vocab_size, shape,
                                        dtype=np.int32)}
        if self.cfg.patch_stub is not None:
            batch["patches"] = rng.standard_normal(
                (d.batch_size, self.cfg.patch_stub.n_patches,
                 self.cfg.patch_stub.embed_dim)).astype(np.float32)
        return batch


class MarkovSource:
    """Tokens from a fixed random bigram chain (learnable structure)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig,
                 branching: int = 4):
        self.cfg = cfg
        self.dcfg = dcfg
        v = cfg.vocab_size
        rng = np.random.Generator(np.random.Philox(key=dcfg.seed + 17))
        # each token can be followed by `branching` successors
        self.successors = rng.integers(0, v, (v, branching), dtype=np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        d = self.dcfg
        rng = np.random.Generator(np.random.Philox(
            key=d.seed, counter=[step, d.shard, 0, 0]))
        b, s = d.batch_size, d.seq_len + 1
        k = self.successors.shape[1]
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.cfg.vocab_size, b)
        choices = rng.integers(0, k, (b, s))
        for t in range(1, s):
            toks[:, t] = self.successors[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}


class HedgedPrefetcher:
    """Race ``k`` loader workers for each next batch; first result wins.

    Loader work is deterministic, so duplicates return identical batches —
    redundancy costs CPU but can only reduce the latency of a slow loader
    (the paper's trade, applied to input pipelines at k copies).
    """

    def __init__(self, source, k: int = 2, depth: int = 2,
                 start_step: int = 0):
        self.source = source
        self.k = max(1, k)
        self._results: dict[int, queue.Queue] = {}
        self._lock = threading.Lock()
        self._next_step = start_step
        self.depth = depth
        self._issued: set[int] = set()
        self.duplicate_wins = 0

    def _result_q(self, step: int) -> queue.Queue:
        with self._lock:
            if step not in self._results:
                self._results[step] = queue.Queue()
            return self._results[step]

    def _issue(self, step: int) -> None:
        if step in self._issued:
            return
        self._issued.add(step)
        q = self._result_q(step)

        def work(copy_idx: int) -> None:
            batch = self.source.batch_at(step)
            q.put((copy_idx, batch))

        for c in range(self.k):
            threading.Thread(target=work, args=(c,), daemon=True).start()

    def get(self, step: int, timeout: float = 60.0) -> PyTree:
        for s in range(step, step + self.depth + 1):
            self._issue(s)
        copy_idx, batch = self._result_q(step).get(timeout=timeout)
        if copy_idx != 0:
            self.duplicate_wins += 1
        with self._lock:
            self._results.pop(step, None)
        return batch
