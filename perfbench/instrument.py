"""The benchmark's own spans and records around calls into the program,
made without editing it: module attributes that the program looks up at
call time are wrapped for the length of a run and put back after.

Always (both runs):
- ``RecordingEngine`` wraps each replica's ``InferenceEngine``: it
  stamps each copy's start and end on the host clock and keeps the
  argmax of every logits row the copy's own prefill and decode steps
  produced (``models.decode._logits``) and the row's values at a set of
  columns drawn from the seed, so the check can hold each served token
  and its logits against the reference.
With ``--trace 1`` also, while the traced window is open, each inside a
``torch.profiler.record_function`` of its name: ``engine.prefill`` and
``engine.decode_step``
(``models.decode``), ``moe`` (``models.lm._run_moe``), ``attention``
(the prefill's ``flash_attention``) and ``attention.decode`` (the
decode step's ``decode_attention``), each of the last two named with the
call's index, whose bound ``flops`` works out from the call's shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time

import numpy as np


def prompt_key(tokens) -> str:
    a = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    return hashlib.blake2b(a.tobytes(), digest_size=12).hexdigest()


@dataclasses.dataclass
class CopyRecord:
    replica: str
    key: str
    t_start: float
    t_end: float = 0.0
    steps: list = dataclasses.field(default_factory=list)    # decode calls
    argmax: list = dataclasses.field(default_factory=list)   # device ints
    logits: list = dataclasses.field(default_factory=list)   # at ``cols``
    out: list | None = None


class Recorder:
    """Holds the run's records and the wrappers it installed."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.active = False   # a traced window is open
        self.local = threading.local()
        self.lock = threading.Lock()
        self.copies: list[CopyRecord] = []
        self.attn_bounds: dict[str, tuple] = {}   # span name -> shapes
        self.cols = None     # the logits columns kept of every row
        self._n = 0
        self._undo: list = []

    def span(self, name: str):
        """A ``record_function`` of ``name`` while a traced window is
        open, else nothing."""
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _patch(self, obj, attr: str, make) -> None:
        orig = getattr(obj, attr)
        self._undo.append((obj, attr, orig))
        setattr(obj, attr, make(orig))

    def install(self) -> None:
        from repro_torch.kernels.decode_attention import ops as da_ops
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.models import decode as dec
        from repro_torch.models import lm

        rec = self

        def logits(orig):
            def wrapped(model, x_last):
                out = orig(model, x_last)
                cur = getattr(rec.local, "copy", None)
                if cur is not None:
                    cur.argmax.append(out.argmax(dim=-1))
                    cur.logits.append(out[..., rec.cols])
                return out
            return wrapped
        self._patch(dec, "_logits", logits)

        def decode_step(orig):
            def wrapped(*a, **k):
                cur = getattr(rec.local, "copy", None)
                if cur is not None:
                    cur.steps.append(time.perf_counter())
                with rec.span("engine.decode_step"):
                    return orig(*a, **k)
            return wrapped
        self._patch(dec, "decode_step", decode_step)
        if not self.trace:
            return

        def spanned(name):
            def make(orig):
                def wrapped(*a, **k):
                    with rec.span(name):
                        return orig(*a, **k)
                return wrapped
            return make
        self._patch(dec, "prefill", spanned("engine.prefill"))
        self._patch(lm, "_run_moe", spanned("moe"))

        def counted(kind):
            def make(orig):
                def wrapped(q, k, v, *a, **kw):
                    if not rec.active:
                        return orig(q, k, v, *a, **kw)
                    with rec.lock:
                        rec._n += 1
                        name = f"{kind}:{rec._n}"
                    b, s, h, hd = q.shape
                    kvh = k.shape[2]
                    live = (int(a[1]) + 1) if kind == "attention.decode" else s
                    rec.attn_bounds[name] = (b, s, h, kvh, hd, live)
                    with rec.span(name):
                        return orig(q, k, v, *a, **kw)
                return wrapped
            return make
        self._patch(fa_ops, "flash_attention", counted("attention"))
        self._patch(da_ops, "decode_attention", counted("attention.decode"))

    def restore(self) -> None:
        while self._undo:
            obj, attr, orig = self._undo.pop()
            setattr(obj, attr, orig)


class RecordingEngine:
    """A replica as the service sees it: the program's engine, with the
    copy's record kept (``Recorder``)."""

    def __init__(self, engine, recorder: Recorder):
        self.engine = engine
        self.name = engine.name
        self.rec = recorder

    def generate(self, prompt, max_new_tokens=16, check_cancel=None):
        cur = CopyRecord(self.name, prompt_key(prompt), time.perf_counter())
        self.rec.local.copy = cur
        out = None
        try:
            out = self.engine.generate(prompt, max_new_tokens,
                                       check_cancel=check_cancel)
        finally:
            cur.t_end = time.perf_counter()
            self.rec.local.copy = None
            if out is not None:
                cur.out = [int(t) for t in out]
            with self.rec.lock:
                self.rec.copies.append(cur)
        return out
