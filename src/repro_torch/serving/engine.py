"""Single-replica inference engine: prefill + greedy decode.

The port of ``repro.serving.engine``. One engine = one replica (one model
copy on its device); request-level parallelism comes from the scheduler
dispatching across replicas — which is exactly the granularity the
paper's redundancy operates at. Cancellation is checked between decode
steps (a duplicate whose sibling finished stops burning compute). The
hedged-serving tests additionally use ``SimulatedEngine`` with
service-time distributions instead of a model.

Where the JAX engine jits ``prefill``/``decode_step`` without ``impl=``
and so serves through its jnp reference, this engine takes ``kernel=``
(``repro_torch.kernels.dispatch``): under the default ``"auto"`` a CUDA
model runs prefill through its kernels (``flash_attention``,
``ssd_scan``, ``rglru_scan``, by layer kind) and every decode step of its
attention layers through the ``decode_attention`` kernel. As the JAX
engine, it feeds (1, S) token prompts: an audio model (token grids) or a
VLM (patch embeddings) is refused and served through
``repro_torch.models.decode``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import decode as dec
from repro_torch.models.lm import LM
from repro_torch.serving.metrics import RequestTrace


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray              # prompt (S,) int32
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    priority: int = 0               # 0 = primary, 1 = duplicate (paper §2.4)
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    cancelled: bool = False
    completed_by: str = ""
    failed: bool = False            # every issued copy errored
    trace: RequestTrace | None = None   # per-copy spans (serving.metrics)


class InferenceEngine:
    """One model replica: prefill + greedy decode (single-slot batching;
    the scheduler parallelizes across replicas). Replicas may share one
    ``model``: an engine only reads the weights, and each request gets
    its own cache."""

    def __init__(self, cfg: ModelConfig, model: LM, max_len: int = 128,
                 name: str = "replica0", device="cuda",
                 kernel: str = "auto"):
        if cfg.family == "audio" or cfg.patch_stub is not None:
            raise ValueError(
                f"{cfg.name}: the engine feeds (1, S) token prompts, as the "
                f"JAX engine does; an audio model or a VLM is served "
                f"through repro_torch.models.decode")
        dev = resolve_device(device)
        w = model.embed.table
        if w.device.type != dev.type or (dev.index is not None
                                         and w.device.index != dev.index):
            raise ValueError(f"the model is on {w.device}, the engine on "
                             f"{dev}")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.name = name
        self.device = w.device
        self.kernel = dispatch.check_mode(kernel)

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 16,
                 check_cancel: Callable[[], bool] | None = None
                 ) -> np.ndarray | None:
        # each step's spans: the host enqueues its ops, then waits on the
        # card for its token (``int``)
        span = tracing.current_copy()
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                               device=self.device)[None]
        span.enqueue("repro.prefill", toks.shape[1])
        logits, cache = dec.prefill(self.model, toks, self.max_len,
                                    kernel=self.kernel)
        out = []
        pos = toks.shape[1]
        tok = torch.argmax(logits, dim=-1)  # (1,)
        span.wait()
        out.append(int(tok[0]))
        span.token()
        for _ in range(max_new_tokens - 1):
            if check_cancel is not None and check_cancel():
                return None
            span.enqueue("repro.decode")
            logits, cache = dec.decode_step(self.model, cache, tok[:, None],
                                            pos, kernel=self.kernel)
            tok = torch.argmax(logits, dim=-1)
            span.wait()
            out.append(int(tok[0]))
            span.token()
            pos += 1
        return np.asarray(out, dtype=np.int32)


class SimulatedEngine:
    """Replica with a service-time model instead of real compute — the
    serving-layer analogue of the paper's queueing-model servers. Service
    times are drawn per request from ``sampler()`` (seconds)."""

    def __init__(self, sampler: Callable[[], float], name: str = "sim0"):
        self.sampler = sampler
        self.name = name

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 16,
                 check_cancel: Callable[[], bool] | None = None):
        t_service = float(self.sampler())
        deadline = time.monotonic() + t_service
        while time.monotonic() < deadline:
            if check_cancel is not None and check_cancel():
                return None
            time.sleep(min(0.0005, max(deadline - time.monotonic(), 0.0)))
        return np.asarray([0] * max_new_tokens, dtype=np.int32)
