"""The one traffic generator: a traffic file's parameters and a seed give
the requests of a run.

Every seed gets the same set of sizes and gaps in another order, so that
runs on different seeds do the same work:

- Lengths are quantiles of the file's distribution: for an open loop, the
  n = rate x seconds quantiles at (j + 1/2) / n; for a closed loop, a pool
  of blocks, each block the same ``strata`` quantiles. Prompt and output
  quantiles are paired by a permutation fixed by the file's ``base_seed``;
  the run's seed shuffles the pairs (within each block for a closed loop).
- Open-loop gaps are the quantiles of an exponential, scaled so that the n
  arrivals fall inside the window, in an order drawn from the seed:
  Poisson-like bursts with a fixed count.
- Prompt token ids are drawn uniformly from ``[3, vocab)`` (past the byte
  tokenizer's three specials), distinct across the run's requests where
  the vocabulary holds them all, so no two prompts share a 16-token block
  and the prefix cache never hits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


@dataclasses.dataclass
class Request:
    rid: str
    due: float                 # seconds after the window opens (open loop)
    prompt: list[int]
    max_tokens: int


def _quantiles(dist: dict[str, Any], n: int) -> np.ndarray:
    """n quantiles at (j + 1/2) / n of a length distribution, rounded and
    clipped to [min, max]."""
    p = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(x)) for x in p])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        v = dist["min"] + p * (dist["max"] - dist["min"])
    elif kind == "fixed":
        v = np.full(n, float(dist["value"]))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(v), dist.get("min", 1), dist.get("max", np.inf)).astype(int)


def _pairs(traffic: dict[str, Any], n: int) -> np.ndarray:
    """[n, 2] (prompt, output) lengths: quantile j of the prompts paired
    with quantile pi(j) of the outputs, pi fixed by ``base_seed``."""
    prompts = _quantiles(traffic["prompt_len"], n)
    outputs = _quantiles(traffic["output_len"], n)
    pi = np.random.default_rng(int(traffic["base_seed"])).permutation(n)
    return np.stack([prompts, outputs[pi]], axis=1)


def _seq(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), stream]))


def open_loop_count(traffic: dict[str, Any], seconds: float) -> int:
    return max(1, int(round(float(traffic["rate_per_s"]) * seconds)))


def generate(traffic: dict[str, Any], seed: int, seconds: float, vocab: int,
             *, stream: int = 0, count: int | None = None) -> list[Request]:
    """The run's requests. Open loop: ``open_loop_count`` requests with due
    times inside ``[0, seconds)``. Closed loop: a pool in the order the
    clients take it (due 0: a client sends when it is free), large enough
    for the fastest rate the file names. ``stream`` separates the window's
    draws from the warm-up's (``warmup``); ``count`` cuts the list."""
    rng = _seq(seed, stream)
    if traffic["loop"] == "open":
        n = open_loop_count(traffic, seconds)
        sizes = _pairs(traffic, n)[rng.permutation(n)]
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)         # Exp(1) quantiles
        gaps = gaps[rng.permutation(n)] * (seconds * n / (n + 1)) / gaps.sum()
        due = np.cumsum(gaps) - gaps[0] * 0.5
    elif traffic["loop"] == "closed":
        strata = int(traffic.get("strata", 16))
        blocks = max(1, math.ceil(float(traffic["pool_per_s"]) * seconds / strata))
        base = _pairs(traffic, strata)
        sizes = np.concatenate([base[rng.permutation(strata)] for _ in range(blocks)])
        due = np.zeros(len(sizes))
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    if count is not None:
        sizes, due = sizes[:count], due[:count]
    total = int(sizes[:, 0].sum())
    if total > vocab - 3:
        # Too few ids to keep them distinct: independent draws, with which
        # a shared 16-token block has probability ~vocab ** -16.
        ids = rng.integers(3, vocab, size=total)
    else:
        ids = rng.permutation(vocab - 3)[:total] + 3
    out, at = [], 0
    for k, (p, o) in enumerate(sizes):
        out.append(Request(rid=f"s{stream}-{k}", due=float(due[k]),
                           prompt=[int(t) for t in ids[at:at + p]], max_tokens=int(o)))
        at += p
    return out


WARMUP_MAX_TOKENS = 16


def warmup(traffic: dict[str, Any], seed: int, vocab: int, n: int) -> list[Request]:
    """``n`` requests of the mix for the warm-up, drawn apart from the
    window's, the first with the longest prompt the mix can draw (so every
    prefill window and the largest allocation happen in set-up). Outputs
    stop at WARMUP_MAX_TOKENS: eager decode has no shape to compile, and
    the engine's own warm-up runs every decode batch bucket."""
    reqs = generate({**traffic, "loop": "closed", "pool_per_s": n, "strata": max(n, 2)},
                    seed, 1.0, vocab, stream=1, count=n)
    reqs[0].prompt = (reqs[0].prompt * 8)[:int(traffic["prompt_len"].get(
        "max", len(reqs[0].prompt)))]
    for r in reqs:
        r.max_tokens = min(r.max_tokens, WARMUP_MAX_TOKENS)
    return reqs
