"""Double-buffered sampling/compute pipeline for the chunked sweep engine.

The chunk loop of ``repro_torch.core.queueing._run_engine`` alternates
two phases per chunk: SAMPLE the chunk's randomness, then DISPATCH the
chunk body. ``iter_staged`` can run them on two threads: a producer
thread draws chunk ``c+1``'s inputs while the main thread dispatches
chunk ``c``'s compute, with a bounded ring of staging slots providing
backpressure — a fixed pool of in-flight buffers, a slot is acquired
before producing into it and released once the consumer has dispatched
the chunk that used it, so at most ``depth`` sampled chunks (plus the
one being consumed) ever exist at once and peak memory stays O(depth x
chunk inputs), independent of the stream length.

On a CUDA card the serial loop already overlaps host and device: the
launches return before the card runs them, so the host samples chunk
``c+1`` while chunk ``c``'s kernel runs. The producer thread then only
overlaps host work with host work, which the interpreter lock
serializes; the engine's default is the serial loop (``pipeline="off"``),
and PERF.md records the two side by side.

Bit-identity: the pipeline changes WHEN inputs are sampled, never WHAT
is sampled — chunk ``c`` still draws from its own (seed, chunk)
generator streams through the same sampler — so ``pipeline="on"`` and
``pipeline="off"`` produce bit-identical summaries (pinned by
tests/test_torch_engine.py).

``PipelineStats`` records the last run's pipeline + sampling shape (per
chunk: rows/bytes actually sampled vs the full input block) so the
benchmark harness can carry per-process sampled-bytes provenance in its
JSON rows (``stats_provenance``); on a sharded run each process draws
only the rows its own shards gather.

This module is the port's copy of ``repro.core.chunkflow``; it imports
neither torch nor JAX, and is engine-agnostic (no ``queueing`` import):
the engine layers feed it plain callables.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading

# Staging slots the producer may fill ahead of the consumer (double
# buffering).
DEFAULT_DEPTH = 2


@dataclasses.dataclass
class PipelineStats:
    """Pipeline + per-process sampling provenance of the last engine run.

    ``*_rows_sampled`` count the input-block rows THIS process drew per
    chunk; ``*_rows_total`` the full block's rows. ``bytes_*`` are the
    same in bytes of the (gaps, servers, services) inputs.
    """

    enabled: bool
    depth: int
    n_chunks: int
    seed_rows_sampled: int
    seed_rows_total: int
    svc_rows_sampled: int
    svc_rows_total: int
    bytes_sampled_per_chunk: int
    bytes_full_per_chunk: int
    process_count: int = 1
    process_index: int = 0

    @property
    def locality_factor(self) -> float:
        """full-block bytes / this process's sampled bytes (>= 1.0)."""
        return self.bytes_full_per_chunk / max(self.bytes_sampled_per_chunk,
                                               1)


_LAST_STATS: list[PipelineStats | None] = [None]


def record_stats(stats: PipelineStats) -> None:
    """Engine layers call this once per run; benchmarks read it back."""
    _LAST_STATS[0] = stats


def last_stats() -> PipelineStats | None:
    return _LAST_STATS[0]


def stats_provenance() -> dict | None:
    """The last run's stats as a JSON-ready dict (the ``sampling`` field
    of ``repro_torch.bench.run --json`` rows)."""
    st = last_stats()
    if st is None:
        return None
    out = dataclasses.asdict(st)
    out["locality_factor"] = round(st.locality_factor, 3)
    return out


def iter_staged(produce, n_chunks: int, *, depth: int = DEFAULT_DEPTH,
                enabled: bool = True):
    """Yield ``produce(c)`` for ``c in range(n_chunks)``, prefetching up
    to ``depth`` chunks ahead on a producer thread when ``enabled``.

    The producer acquires a staging slot (blocking when ``depth`` chunks
    are already in flight), fills it with ``produce(c)``, and the
    consumer releases the slot after the yield returns — i.e. once the
    caller has dispatched that chunk's compute and come back for the
    next one. Order is preserved exactly (a single producer fills slots
    in chunk order). A producer exception is re-raised here, in the
    consumer, at the chunk that failed; closing the generator early
    (consumer exception) stops the producer promptly via the stop flag
    the slot-acquire loop polls.

    ``enabled=False`` (or a single chunk, where there is nothing to
    overlap) degrades to the plain serial loop — the pipeline-off
    reference path.
    """
    if not enabled or n_chunks <= 1 or depth < 1:
        for c in range(n_chunks):
            yield produce(c)
        return

    free = threading.Semaphore(depth)       # staging slots (buffer pool)
    ready: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
    stop = threading.Event()

    def producer() -> None:
        for c in range(n_chunks):
            while not free.acquire(timeout=0.1):
                if stop.is_set():
                    return
            if stop.is_set():
                return
            try:
                ready.put((c, produce(c), None))
            except BaseException as e:  # surface in the consumer
                ready.put((c, None, e))
                return

    th = threading.Thread(target=producer, name="chunkflow-producer",
                          daemon=True)
    th.start()
    try:
        for c in range(n_chunks):
            got_c, payload, err = ready.get()
            assert got_c == c, (got_c, c)
            if err is not None:
                raise err
            yield payload
            free.release()  # chunk dispatched; its slot is reusable
    finally:
        stop.set()
        free.release()  # wake a producer blocked on a full ring
        th.join(timeout=30.0)
