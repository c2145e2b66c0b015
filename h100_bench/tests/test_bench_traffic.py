"""The traffic generator: a seed gives the same requests every time, and
every seed the same sizes and gaps in another order."""

from collections import Counter

from h100_bench import traffic

CHAT = {"loop": "open", "rate_per_s": 5.0, "base_seed": 3,
        "prompt_len": {"dist": "lognormal", "median": 256, "sigma": 1.0, "min": 32, "max": 2048},
        "output_len": {"dist": "lognormal", "median": 128, "sigma": 0.7, "min": 16, "max": 512}}
LONG = {"loop": "closed", "clients": 4, "strata": 16, "pool_per_s": 4, "base_seed": 4,
        "prompt_len": {"dist": "uniform", "min": 2048, "max": 4000},
        "output_len": {"dist": "fixed", "value": 1}}


def _sig(reqs):
    return [(r.rid, r.due, tuple(r.prompt), r.max_tokens) for r in reqs]


def test_same_seed_same_requests():
    for tf in (CHAT, LONG):
        a = traffic.generate(tf, 2**33 + 5, 20.0, 32000)
        b = traffic.generate(tf, 2**33 + 5, 20.0, 32000)
        assert _sig(a) == _sig(b)
        assert _sig(a) != _sig(traffic.generate(tf, 2**33 + 6, 20.0, 32000))


def test_seeds_share_sizes_and_gaps():
    a = traffic.generate(CHAT, 11, 40.0, 32000)
    b = traffic.generate(CHAT, 12, 40.0, 32000)
    assert len(a) == len(b) == 200
    sizes = lambda rs: Counter((len(r.prompt), r.max_tokens) for r in rs)  # noqa: E731
    assert sizes(a) == sizes(b)
    # The first arrival sits half its gap into the window.
    gaps = lambda rs: sorted([round(2 * rs[0].due, 9)] + [  # noqa: E731
        round(y.due - x.due, 9) for x, y in zip(rs, rs[1:])])
    assert gaps(a) == gaps(b)
    assert [r.due for r in a] != [r.due for r in b]
    assert all(0 <= r.due < 40.0 for r in a)
    assert max(len(r.prompt) for r in a) == 2048 and min(len(r.prompt) for r in a) >= 32


def test_closed_pool_blocks_and_unshared_prompts():
    reqs = traffic.generate(LONG, 9, 30.0, 151936)
    assert len(reqs) % 16 == 0 and len(reqs) >= 4 * 30
    first = Counter(len(r.prompt) for r in reqs[:16])
    assert first == Counter(len(r.prompt) for r in reqs[16:32])
    assert all(r.max_tokens == 1 for r in reqs)
    heads = {tuple(r.prompt[:16]) for r in reqs}
    assert len(heads) == len(reqs)
    ids = [t for r in reqs for t in r.prompt]
    assert min(ids) >= 3 and max(ids) < 151936


def test_warmup_reaches_the_longest_prompt_and_differs_from_the_window():
    warm = traffic.warmup(CHAT, 5, 32000, 4)
    assert len(warm[0].prompt) == 2048
    assert all(r.max_tokens <= traffic.WARMUP_MAX_TOKENS for r in warm)
    window = {tuple(r.prompt[:16]) for r in traffic.generate(CHAT, 5, 10.0, 32000)}
    assert not window & {tuple(r.prompt[:16]) for r in warm}
