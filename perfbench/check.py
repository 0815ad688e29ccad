"""What decides ``correct``: every request sent in the window finished
once, none failed, each with the tokens that its own winning copy's
logits give (the argmax the timed path computed, recorded at
``models.decode._logits``), and, over a sample of the finished requests
drawn from the seed with the longest among them, the numbers the cell's
own file (``cells/<workload>.json``) gives limits for, against the plain
reference run over the prompt and the served tokens
(``reference/<family>.py``, in float32 or the configuration's own
precision): the widest gap by which a served token's logit lies below
the reference's best (``served_gap``), or the distance of the served
logits from the reference's, the widest (``logit_error``) or its median
and quartile (``readings``). Each number is printed beside its limit.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from perfbench import instrument


def sample(records: list, n: int, seed: int) -> list:
    """The finished requests the reference reads: the longest (prompt
    and served tokens) and ``n - 1`` more drawn from ``seed``."""
    done = [r for r in records if r["req"].done_event.is_set()
            and not r["req"].failed]
    if not done:
        return []
    size = [r["item"].prompt_len + r["item"].new_tokens for r in done]
    first = int(np.argmax(size))
    rest = [i for i in range(len(done)) if i != first]
    rng = np.random.default_rng([abs(int(seed)), 7])
    pick = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [done[first]] + [done[int(i)] for i in sorted(pick)]


def _by_key(copies: list) -> dict:
    out: dict[str, list] = {}
    for c in copies:
        out.setdefault(c.key, []).append(c)
    return out


def winning_copy(r: dict, by_key: dict):
    """The copy that served request ``r``: on the replica the service
    names, with the tokens it served, whose own logits give them."""
    import torch
    req = r["req"]
    out = list(req.out_tokens)
    for c in by_key.get(instrument.prompt_key(req.tokens), []):
        if c.replica != req.completed_by or c.out != out or not c.argmax:
            continue
        if torch.cat([a.reshape(-1) for a in c.argmax]).tolist() == out:
            return c
    return None


def bookkeeping(records: list, copies: list, completions: int) -> int:
    """Requests whose served tokens are not those of a copy of theirs on
    the replica the service names, as its own logits give them, or not
    as many as asked; plus any difference between the requests finished
    and the completions the service counted."""
    by_key = _by_key(copies)
    bad = finished = 0
    for r in records:
        req = r["req"]
        if not req.done_event.is_set() or req.failed:
            continue
        finished += 1
        if (winning_copy(r, by_key) is None
                or len(req.out_tokens) != r["item"].new_tokens):
            bad += 1
    return bad + abs(completions - finished)


def readings(s, rows: list, copies: list, control: bool = False) -> dict:
    """Over the sampled requests ``rows``, each number the check can
    compare, against the reference in the precision the configuration's
    ``check`` names (``reference_precision``, float32 unless given):

    - ``served_gap``: the widest over the served positions of the
      reference's best logit minus its logit of the token served;
    - ``logit_error``: the largest distance between the logits the timed
      path produced and the reference's, over the columns kept
      (``Recorder.cols``), in units of the reference row's RMS;
    - ``logit_error_median``, ``logit_error_p75``: that distance's
      median and upper quartile over the served positions (a few
      positions whose experts a near-tie flipped do not move them; a
      fault in a quarter of them or more moves the quartile);
      ``logit_error_decode_median``: its median over the decode steps'
      positions alone (each request's served tokens after its first);
    and with ``control``, the same of the reference computed in fp8 in
    the program's place (``control_gap``: the gap of the token it puts
    first; ``control_logit_error`` and its ``_median``, ...)."""
    import torch
    dev = s.device
    seqs, plens, want, served = [], [], [], []
    for r in rows:
        p = r["item"].prompt_len
        out = list(r["req"].out_tokens)
        toks = np.concatenate([np.asarray(r["req"].tokens, np.int64),
                               np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=dev))
        plens.append(p)
        want.append(list(range(p - 1, p - 1 + len(out))))
        served.append(out)
    base = s.cell.config["check"].get("reference_precision", "float32")
    ref32 = s.ref.logits_at(s.params, s.port, seqs, plens, want,
                            precision=base)
    ref8 = (s.ref.logits_at(s.params, s.port, seqs, plens, want,
                            precision="fp8") if control else [None] * len(rows))
    by_key = _by_key(copies)
    cols = s.recorder.cols
    gaps = {"served_gap": [], "control_gap": []}
    errs = {"logit_error": [], "control_logit_error": []}
    for r, lg, lo, out in zip(rows, ref32, ref8, served):
        best = lg.max(dim=-1).values
        rms = lg.square().mean(dim=-1).sqrt()
        tok = torch.as_tensor(out, device=dev)[:, None]
        gaps["served_gap"] += (best - lg.gather(1, tok)[:, 0]).tolist()
        c = winning_copy(r, by_key)
        if c is not None:
            prog = torch.cat([x.reshape(1, -1) for x in c.logits])
            errs["logit_error"].append(
                ((prog - lg[:, cols]).abs().amax(dim=-1) / rms).tolist())
        if lo is not None:
            gaps["control_gap"] += (best - lg.gather(
                1, lo.argmax(dim=-1, keepdim=True))[:, 0]).tolist()
            errs["control_logit_error"].append(
                ((lo[:, cols] - lg[:, cols]).abs().amax(dim=-1)
                 / rms).tolist())
    out = {}
    for k, v in gaps.items():
        if v or k == "served_gap" or control:
            out[k] = max(v) if v else float("inf")
    for k, per_row in errs.items():
        if k.startswith("control") and not control:
            continue
        every = [e for row in per_row for e in row]
        decode = [e for row in per_row for e in row[1:]]
        out[k] = max(every) if every else float("inf")
        out[f"{k}_median"] = float(np.median(every)) if every else float("inf")
        out[f"{k}_p75"] = (float(np.percentile(every, 75)) if every
                           else float("inf"))
        out[f"{k}_decode_median"] = (float(np.median(decode)) if decode
                                     else float("inf"))
    return out


def check(s, w, seed: int) -> dict:
    limits = s.cell.own["limits"]
    recs = w.records
    unfinished = sum(not r["req"].done_event.is_set() for r in recs)
    failed = sum(r["req"].done_event.is_set() and r["req"].failed
                 for r in recs)
    book = bookkeeping(recs, s.recorder.copies, w.completions)
    n = int(s.cell.config["check"]["sample_requests"])
    t = time.perf_counter()
    rows = sample(recs, n, seed)
    got = readings(s, rows, s.recorder.copies) if rows else {}
    print(f"reference: {len(rows)} requests, "
          f"{sum(len(r['req'].out_tokens) for r in rows)} served tokens, "
          f"{sum(r['item'].prompt_len for r in rows)} prompt tokens, in "
          f"{time.perf_counter() - t:.1f} s; readings {got}",
          file=sys.stderr, flush=True)
    numbers = {
        "unfinished": {"value": unfinished, "limit": 0},
        "failed": {"value": failed, "limit": 0},
        "bookkeeping": {"value": book, "limit": 0},
    }
    for name, limit in limits.items():
        numbers[name] = {"value": got.get(name, float("inf")),
                         "limit": limit}
    ok = all(v["value"] <= v["limit"] for v in numbers.values())
    return {"correct": bool(ok), "failed": unfinished + failed,
            "numbers": numbers}
