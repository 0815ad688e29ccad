"""§3.1: TCP handshake duplication — expected savings vs the cost
benchmark. The draws run on the device; means and percentiles are taken
on the host in numpy (linear interpolation)."""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import analytic


def run(smoke: bool = False, device="cuda") -> list[Row]:
    m = analytic.TCPModel()
    n = 20_000 if smoke else 400_000
    (t1, t2), us = timed(lambda: tuple(
        analytic.handshake_times(8, m, n, duplicated=dup,
                                 device=device).cpu().numpy()
        for dup in (False, True)))
    mean_save = float(np.mean(t1) - np.mean(t2))
    p995 = float(np.percentile(t1, 99.5) - np.percentile(t2, 99.5))
    p999 = float(np.percentile(t1, 99.9) - np.percentile(t2, 99.9))
    # 3 packets * 50 B = 150 B extra per handshake
    ms_per_kb = mean_save * 1e3 / (150 / 1024)
    return [("tcp/handshake", us,
             f"mean_saving_ms={mean_save * 1e3:.1f};"
             f"first_order_ms={analytic.handshake_mean_saving(m) * 1e3:.1f};"
             f"p995_saving_ms={p995 * 1e3:.0f};"
             f"p999_saving_ms={p999 * 1e3:.0f};"
             f"ms_per_kb={ms_per_kb:.0f};"
             f"benchmark={analytic.BENEFIT_THRESHOLD_MS_PER_KB}")]
