"""The one general traffic generator: a mix is a file of parameters
(``traffic/<mix>.json``) and nothing else.

Keys of a mix:

- ``loop``: ``"open"`` (requests are due on a schedule, whatever the
  service does; ``arrivals`` ``"poisson"``, at ``rate_share`` of the
  cell's sustained rate, which the cell's own file gives) or
  ``"closed"`` (``clients`` callers, each sending its next request when
  its reply arrives);
- ``prompt_len`` and ``new_tokens``: distributions
  (``{"dist": "log_uniform" | "uniform_int", "lo": .., "hi": ..}``,
  bounds included);
- ``requests``: the length of the schedule;
- ``schedule_seed``: the seed of the schedule itself.

The schedule (each request's prompt length, new tokens and, in an open
loop, due time) is drawn from ``schedule_seed`` alone, so every
``--seed`` sends the same amount of work at the same times; ``--seed``
draws every token id (uniform over the vocabulary), the weights and the
sample that the check reads. A Poisson schedule drawn anew for every
seed spreads a tail at four fifths of capacity by 30-50% between seeds
(a queue's latency follows the order of its arrivals), which no bound a
check allows could hold.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Item:
    index: int
    prompt_len: int
    new_tokens: int
    due_s: float | None       # open loop: seconds after the window opens


def _draw(dist: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if not 1 <= lo <= hi:
        raise ValueError(f"bad bounds in {dist}")
    if dist["dist"] == "uniform_int":
        return rng.integers(lo, hi + 1, size=n)
    if dist["dist"] == "log_uniform":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def schedule(mix: dict, rate_per_s: float | None = None) -> list[Item]:
    """The mix's requests in the order they are sent. ``rate_per_s``:
    the open loop's arrival rate."""
    n = int(mix["requests"])
    rng = np.random.default_rng(int(mix["schedule_seed"]))
    lens = _draw(mix["prompt_len"], rng, n)
    new = _draw(mix["new_tokens"], rng, n)
    due = [None] * n
    if mix["loop"] == "open":
        if mix.get("arrivals", "poisson") != "poisson":
            raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
        if not rate_per_s or rate_per_s <= 0:
            raise ValueError("an open loop needs a positive rate")
        gaps = rng.standard_exponential(n) / rate_per_s
        due = np.concatenate([[0.0], np.cumsum(gaps[:-1])]).tolist()
    elif mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return [Item(i, int(lens[i]), int(new[i]), due[i]) for i in range(n)]


def rate(mix: dict, own: dict) -> float | None:
    """The open loop's rate in a cell: the mix's share of the sustained
    rate that the cell's own file records (found by a sweep)."""
    if mix["loop"] != "open":
        return None
    return float(mix["rate_share"]) * float(own["sustained_rate_per_s"])


def prompts(items: list[Item], vocab: int, seed: int) -> list[np.ndarray]:
    """Token ids of every prompt, uniform over ``vocab``, from ``seed``."""
    rng = np.random.default_rng(abs(int(seed)))
    flat = rng.integers(0, vocab, size=sum(it.prompt_len for it in items),
                        dtype=np.int32)
    cuts = np.cumsum([it.prompt_len for it in items])[:-1]
    return np.split(flat, cuts)


def max_positions(mix: dict) -> int:
    """The most positions a request of the mix takes in the cache."""
    return int(mix["prompt_len"]["hi"]) + int(mix["new_tokens"]["hi"]) - 1
