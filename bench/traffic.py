"""The one traffic generator: a traffic mix is a JSON file of parameters
under ``bench/traffic/``, and this module turns it into a stream of
requests.

Every seed gets the same work.  Prompt and output lengths are the
quantiles of the mix's distributions at ``strata`` evenly spaced
probabilities; each block of ``strata`` consecutive requests holds every
quantile exactly once, in an order drawn from the seed (prompt and output
lengths permuted independently), and each aligned run of ``substrata``
requests inside it takes one size from each of ``substrata`` groups of
neighbouring quantiles.  So any run of requests is nearly the same
multiset of sizes, shuffled, and runs on different seeds differ in order
and token ids only.  Token ids are uniform on ``[id_low, vocab)``.

Streams: one seed yields disjoint streams by ``stream`` number (the
warm-up's sweep, the warm-up's traffic, the window's, and the draws of
the correctness sample and of the first requests' shares).
"""
from __future__ import annotations

import json
from pathlib import Path
from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

SWEEP_STREAM = 0
WARMUP_STREAM = 1
WINDOW_STREAM = 2
SAMPLE_STREAM = 3        # the correctness check's draw of finished requests
COHORT_STREAM = 101      # the first requests' shares of their outputs


def load(name: str, root: Path = TRAFFIC_DIR) -> Dict:
    path = root / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"{path}: name {mix.get('name')!r} is not {name!r}")
    if mix.get("loop") != "closed":
        raise ValueError(f"{path}: only closed-loop mixes are generated")
    return mix


def quantiles(spec: Dict, k: int) -> np.ndarray:
    """The ``k`` lengths of ``spec`` at probabilities (i + 0.5) / k, as
    whole numbers clipped to [min, max].  ``dist``: ``lognormal``
    (``median``, ``sigma``) or ``uniform`` (``min`` to ``max``)."""
    probs = (np.arange(k) + 0.5) / k
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        nd = NormalDist()
        z = np.array([nd.inv_cdf(float(p)) for p in probs])
        vals = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
    elif spec["dist"] == "uniform":
        vals = lo + probs * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def seed_words(seed: int, stream: int) -> Tuple[int, ...]:
    """Non-negative words for numpy's SeedSequence from any whole seed."""
    return (seed & (2 ** 64 - 1), stream)


def requests(mix: Dict, vocab: int, seed: int, stream: int
             ) -> Iterator[Tuple[np.ndarray, int]]:
    """Endless (prompt ids int32, max_new_tokens) pairs of ``mix``."""
    k = int(mix["strata"])
    prompts = quantiles(mix["prompt"], k)
    outputs = quantiles(mix["output"], k)
    sub = int(mix.get("substrata", k))
    rng = np.random.default_rng(seed_words(seed, stream))
    low = int(mix.get("id_low", 0))
    while True:
        p_order = block_order(rng, k, sub)
        o_order = block_order(rng, k, sub)
        for i in range(k):
            n = int(prompts[p_order[i]])
            ids = rng.integers(low, vocab, size=n, dtype=np.int32)
            yield ids, int(outputs[o_order[i]])


def block_order(rng, k: int, sub: int) -> List[int]:
    """An order of the ``k`` quantile indices of one block in which every
    aligned run of ``sub`` entries takes one index from each of ``sub``
    groups of ``k / sub`` neighbouring quantiles, so a window shorter than
    a block still meets every part of the distribution alike."""
    if k % sub:
        raise ValueError(f"substrata {sub} does not divide strata {k}")
    g = k // sub
    groups = [rng.permutation(g) + j * g for j in range(sub)]
    out: List[int] = []
    for i in range(g):
        out.extend(int(x) for x in rng.permutation(
            [groups[j][i] for j in range(sub)]))
    return out


def sweep(mix: Dict, vocab: int, seed: int, n: int, copies: int
          ) -> List[List[np.ndarray]]:
    """For ``n`` of the mix's prompt quantiles, evenly spaced from the
    shortest to the longest, ``copies`` distinct prompts of that size, for
    a warm-up that meets every size alone and in groups."""
    k = int(mix["strata"])
    sizes = quantiles(mix["prompt"], k)
    idx = sorted({int(round(i * (k - 1) / max(1, n - 1))) for i in range(n)})
    rng = np.random.default_rng(seed_words(seed, SWEEP_STREAM))
    low = int(mix.get("id_low", 0))
    return [[rng.integers(low, vocab, size=int(sizes[i]), dtype=np.int32)
             for _ in range(copies)] for i in idx]


def cohort_fractions(n: int, seed: int) -> np.ndarray:
    """For the first request of each of ``n`` clients: the share of its
    drawn output it still has to make, evenly spread over (0, 1] and
    shuffled by the seed, so the clients start at every point of a
    request's life and finish at a steady rate from the start."""
    rng = np.random.default_rng(seed_words(seed, COHORT_STREAM))
    return (rng.permutation(n) + 1) / n
