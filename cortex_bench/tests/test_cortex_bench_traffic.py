"""The traffic generator: repeatable by seed, true to its mix's parameters."""
import json
from collections import Counter
from pathlib import Path

import pytest

from cortex_bench.traffic import WORDS, Traffic, load_mix, prompt_limit

HERE = Path(__file__).resolve().parents[1]

OPEN = {"loop": "open", "rate_per_s": 2.0, "pool": 16,
        "preamble_bytes": {"dist": "lognormal", "median": 256, "sigma": 0.6, "lo": 32, "hi": 768},
        "tags": {"share": 0.25, "count": [1, 3], "words": [3, 8]}, "max_new_tokens": [16, 64],
        "river_margin": 256, "engine": {"main_capacity": 2048, "inject_tokens": 16}}


def test_same_seed_same_requests_other_seed_other_order():
    mix = load_mix("council")
    a, b, c = Traffic(mix, 7), Traffic(mix, 7), Traffic(mix, 8)
    ra = [a.request(i) for i in range(32)]
    assert ra == [b.request(i) for i in range(32)]
    rc = [c.request(i) for i in range(32)]
    assert [r.prompt for r in ra] != [r.prompt for r in rc]
    # every seed draws the same sizes, in another order: each pool of
    # consecutive requests holds every preamble size once, and a request's
    # tags have the same lengths whatever the seed
    assert sorted(a.pre) == sorted(c.pre)
    assert sorted(r.max_new_tokens for r in ra) == sorted(r.max_new_tokens for r in rc)
    tag_lengths = lambda r: sorted(len(t) for t in r.tasks)
    assert all(tag_lengths(x) == tag_lengths(y) for x, y in zip(ra, rc))
    for n in range(0, 32, a.pool):
        assert sorted(len(r.prompt) for r in ra[n:n + a.pool]) == sorted(len(r.prompt) for r in rc[n:n + a.pool])


@pytest.mark.parametrize("multiple", [1, 128])
def test_council_requests_match_the_mix(multiple):
    mix = load_mix("council")
    tr = Traffic(mix, 2**31 + 5, prompt_multiple=multiple)
    limit = prompt_limit(mix)
    assert limit == 2048 - 24 * 16 - 256
    for i in range(48):
        r = tr.request(i)
        n = len(r.prompt.encode()) + 1  # the BOS
        assert n <= limit
        if multiple > 1:
            assert n % multiple == 0 or n <= multiple
        assert len(r.tasks) == 24 and r.max_new_tokens == 64 and r.due is None
        assert sorted(Counter(len(t.split()) for t in r.tasks)) == [3, 4, 5, 6, 7, 8]
        for t in r.tasks:
            assert f"[TASK: {t}]" in r.prompt and len(f"[TASK: {t}]") <= 64
            assert all(w in WORDS for w in t.split())
        pre = r.prompt.split(" [TASK:")[0]
        assert "[" not in pre and "]" not in pre


def test_open_loop_arrivals_and_sizes():
    tr = Traffic(OPEN, 11)
    due = [tr.due(i) for i in range(160)]
    assert due[0] == 0.0 and all(b > a for a, b in zip(due, due[1:]))
    # the stratified gaps of each pool-long stretch average near 1 / rate
    assert abs((due[16] - due[0]) / 16 - 0.5) < 0.2
    reqs = [tr.request(i) for i in range(64)]
    tagged = [r for r in reqs if r.tasks]
    assert len(tagged) == 16  # a quarter of each pool
    assert all(1 <= len(r.tasks) <= 3 for r in tagged)
    assert all(16 <= r.max_new_tokens <= 64 for r in reqs)
    assert all(len(r.prompt.encode()) + 1 <= prompt_limit(OPEN) for r in reqs)


def test_each_mix_file_is_one_the_generator_takes():
    for path in (HERE / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        tr = Traffic(mix, 3, prompt_multiple=128)
        assert tr.request(0).prompt


def test_bursts_and_tenants_are_parameters_of_the_mix():
    mix = {**OPEN, "burst": 4, "tenants": {"a": {"weight": 4.0, "share": 0.75}, "b": {"weight": 1.0, "share": 0.25}}}
    tr, again = Traffic(mix, 11), Traffic(mix, 11)
    due = [tr.due(i) for i in range(128)]
    # four requests due together, the bursts' starts at a quarter of the rate
    assert all(len(set(due[n:n + 4])) == 1 for n in range(0, 128, 4))
    starts = due[::4]
    assert all(b > a for a, b in zip(starts, starts[1:]))
    assert abs((starts[16] - starts[0]) / 16 - 4 / mix["rate_per_s"]) < 0.8
    reqs = [tr.request(i) for i in range(64)]
    assert reqs == [again.request(i) for i in range(64)]
    for n in range(0, 64, 16):  # each pool holds each tenant at its share
        assert Counter(r.tenant for r in reqs[n:n + 16]) == {"a": 12, "b": 4}
    assert all(Traffic(OPEN, 11).request(i).tenant == "default" for i in range(4))
    with pytest.raises(ValueError):
        Traffic({**mix, "tenants": {"a": {"weight": 1.0, "share": 0.5}}}, 11)
