"""The traffic generator: the same seed gives the same requests, another
seed another order of the same sizes."""
import itertools

import numpy as np
import pytest

import traffic


def take(mix, seed, stream, n, vocab=1000):
    return list(itertools.islice(traffic.requests(mix, vocab, seed, stream),
                                 n))


@pytest.mark.parametrize("name", ["rag-prefill", "chat-decode", "repo-chat"])
def test_same_seed_same_traffic(name):
    mix = traffic.load(name)
    a = take(mix, 2 ** 31 + 11, traffic.WINDOW_STREAM, 80)
    b = take(mix, 2 ** 31 + 11, traffic.WINDOW_STREAM, 80)
    assert [n for _, n in a] == [n for _, n in b]
    assert all(np.array_equal(p, q) for (p, _), (q, _) in zip(a, b))


@pytest.mark.parametrize("name", ["rag-prefill", "chat-decode", "repo-chat"])
def test_seeds_and_streams_differ(name):
    mix = traffic.load(name)
    base = take(mix, 7, traffic.WINDOW_STREAM, 64)
    for other in (take(mix, 8, traffic.WINDOW_STREAM, 64),
                  take(mix, 7, traffic.WARMUP_STREAM, 64)):
        assert [len(p) for p, _ in base] != [len(p) for p, _ in other]
        assert not all(np.array_equal(p[:8], q[:8])
                       for (p, _), (q, _) in zip(base, other))


@pytest.mark.parametrize("name", ["rag-prefill", "chat-decode", "repo-chat"])
def test_every_block_holds_the_same_sizes(name):
    """Each block of ``strata`` requests is the quantile set, shuffled, on
    every seed: runs on different seeds get the same work."""
    mix = traffic.load(name)
    k = mix["strata"]
    want_p = sorted(traffic.quantiles(mix["prompt"], k))
    want_o = sorted(traffic.quantiles(mix["output"], k))
    for seed in (0, 1, 2 ** 33 + 5):
        reqs = take(mix, seed, traffic.WINDOW_STREAM, 3 * k, vocab=50)
        for b in range(3):
            block = reqs[b * k:(b + 1) * k]
            assert sorted(len(p) for p, _ in block) == want_p
            assert sorted(n for _, n in block) == want_o
            assert all(p.min() >= mix["id_low"] and p.max() < 50
                       for p, _ in block)


def test_quantiles_by_hand():
    spec = {"dist": "uniform", "min": 16, "max": 64}
    q = traffic.quantiles(spec, 49)
    assert q[0] == 16 and q[-1] == 64 and len(set(q)) == 49
    spec = {"dist": "lognormal", "median": 100, "sigma": 1.0, "min": 10,
            "max": 1000}
    q = traffic.quantiles(spec, 3)
    # probabilities 1/6, 1/2, 5/6: z = -0.9674, 0, 0.9674
    assert list(q) == [38, 100, 263]
    assert list(traffic.quantiles(dict(spec, min=50, max=200), 3)) == \
        [50, 100, 200]


def test_sweep_spans_the_sizes_with_distinct_copies():
    mix = traffic.load("chat-decode")
    sw = traffic.sweep(mix, 1000, 5, 16, 4)
    sizes = [len(g[0]) for g in sw]
    q = traffic.quantiles(mix["prompt"], mix["strata"])
    assert sizes[0] == q.min() and sizes[-1] == q.max()
    assert sizes == sorted(sizes) and len(sw) == 16
    for g in sw:
        assert len(g) == 4 and len({p.tobytes() for p in g}) == 4
        assert {len(p) for p in g} == {len(g[0])}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 1])
def test_every_sub_block_meets_every_part_of_the_distribution(seed):
    mix = traffic.load("repo-chat")
    k, sub = mix["strata"], mix["substrata"]
    q = sorted(traffic.quantiles(mix["prompt"], k))
    edges = [q[j * (k // sub)] for j in range(sub)]   # each group's least
    reqs = take(mix, seed, traffic.WINDOW_STREAM, 2 * k)
    for i in range(0, 2 * k, sub):
        groups = sorted(sum(len(p) >= e for e in edges) for p, _ in
                        reqs[i:i + sub])
        assert groups == list(range(1, sub + 1))
    with pytest.raises(ValueError):
        traffic.block_order(np.random.default_rng(0), 64, 7)
