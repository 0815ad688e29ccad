"""Shared benchmark utilities: timing + CSV rows `name,us_per_call,derived`.

Rows may append provenance elements past the 3-tuple core:

  * 4th — the mesh shape tuple the row executed under (``None`` /
    absent for unsharded rows); ``run.py`` records it as the row's
    ``mesh`` field in the JSON artifact.
  * 5th — the row's scenario provenance (``repro_torch.core.scenario
    .provenance``: policy, service model, mix, ks, overhead, dists) or
    ``None``; ``run.py`` records it as the row's ``scenario`` field.
  * 6th — the RESOLVED cell-update kernel mode the row executed under
    (``"on"`` / ``"off"``, ``kernels.dispatch.resolve``), or ``None`` for rows
    with no engine call; ``run.py`` records it as the row's ``kernel``
    field so trajectories separate kernel-path from plain-path
    measurements.
  * 7th — the row's sampling/pipeline provenance
    (``repro_torch.core.chunkflow.stats_provenance()``: pipeline on/off,
    per-process sampled rows and bytes vs the full block, locality
    factor, process count) or ``None``; ``run.py`` records it as the
    row's ``sampling`` field.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Union

import torch

Row = tuple  # (name, us, derived[, mesh[, scenario[, kernel[, sampling]]]])


def timed(fn: Callable[[], Any]) -> tuple[Any, float]:
    """``(fn(), microseconds)``, the card's queued work included."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e6


def row_provenance(row: Row) -> tuple[Optional[list], Union[dict, list,
                                                            None],
                                      Optional[str]]:
    """(mesh, scenario, kernel) provenance of a row, tolerating the short
    forms."""
    mesh = list(row[3]) if len(row) > 3 and row[3] is not None else None
    scn = row[4] if len(row) > 4 else None
    kernel = row[5] if len(row) > 5 else None
    return mesh, scn, kernel


def row_sampling(row: Row) -> Optional[dict]:
    """The row's sampling provenance (its 7th element), or ``None``."""
    return row[6] if len(row) > 6 else None


def emit(rows: list[Row]) -> None:
    for row in rows:
        name, us, derived = row[:3]
        print(f"{name},{us:.1f},{derived}")
