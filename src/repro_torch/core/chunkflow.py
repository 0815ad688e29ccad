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
tests/test_torch_engine.py). This module is the port's copy of the
pipeline of ``repro.core.chunkflow``; it imports neither torch nor JAX,
and is engine-agnostic (no ``queueing`` import): the engine feeds it
plain callables.
"""
from __future__ import annotations

import queue as queue_mod
import threading

# Staging slots the producer may fill ahead of the consumer (double
# buffering).
DEFAULT_DEPTH = 2


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
