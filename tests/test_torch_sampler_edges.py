"""Sampler edge cases of the port (``repro_torch.serving.sampler``): the six
cases of ``tests/test_sampler_edges.py``.

They hold support and determinism, not the reference's draws: the
reference samples from a JAX ``rbg`` key chain that PyTorch cannot replay
(ROADMAP, the sampling rule), so where the reference test compares two
spellings of one program under one key, these compare them under one
seeded ``torch.Generator``, and where it compares draws with the
reference's, these hold every draw, the port's and the reference's alike,
inside the reference path's support (``_ref_allowed``, a numpy mirror of
the reference's ``sample()`` filters).

Ported cases: ``test_top_k_geq_vocab_equals_disabled_bitwise``,
``test_top_p_one_is_disabled_and_full_support``,
``test_temperature_near_zero_equals_argmax``,
``test_temperature_epsilon_matches_reference_sample`` (it compared two
reference draws token for token; both reduce to the argmax, so here the
port's ``sample`` and ``sample_lanes`` equal the argmax and the reference's
``sample`` lies in its own support, which is that argmax),
``test_mixed_greedy_filtered_lanes_match_reference_support`` and
``test_property_draws_stay_in_reference_support`` (hypothesis, 25
examples). ``test_torch_engine.py::test_sample_lanes_support_matches_reference``
is the near counterpart of the mixed-lanes case at other parameters, and
holds that one generator seed repeats its draws.

Logits are made from a seed with numpy. Where a case asserts the argmax
under a clamped tiny temperature (1e-6), it first asserts that each row's
top-2 logit margin exceeds 1e-3, so the Gumbel noise scaled by 1e-6 cannot
reorder it. No tolerance: every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from conftest import hypothesis_tools

from repro.serving.sampler import SamplingParams as JaxSampling
from repro.serving.sampler import sample as jax_sample
from repro.serving.sampler import sample_lanes as jax_sample_lanes
from repro.serving.sampler import stack_lane_params as jax_stack
from repro_torch.serving.sampler import SamplingParams, lane_params, sample, sample_lanes, stack_lane_params

given, settings, st = hypothesis_tools()


def _logits(seed, b, v):
    return np.random.default_rng(seed).standard_normal((b, v), dtype=np.float32) * 3.0


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _stack(ps):
    return stack_lane_params(ps, device="cpu")


def _jax_params(p: SamplingParams) -> JaxSampling:
    return JaxSampling(temperature=p.temperature, top_k=p.top_k, top_p=p.top_p, greedy=p.greedy)


def _ref_allowed(row: np.ndarray, p: SamplingParams) -> np.ndarray:
    """Boolean support of the reference ``sample()`` path for one lane: a
    numpy mirror of its sequential top-k -> (renormalised) top-p filter."""
    v = row.shape[0]
    if p.greedy or p.temperature <= 0.0:
        out = np.zeros(v, bool)
        out[int(np.argmax(row))] = True
        return out
    x = row / max(p.temperature, 1e-6)
    if p.top_k > 0:
        kth = np.sort(x)[::-1][min(p.top_k, v) - 1]
        x = np.where(x < kth, -np.inf, x)
    if p.top_p < 1.0:
        s = np.sort(x)[::-1]
        probs = np.exp(s - s.max())
        probs = probs / probs.sum()
        cum = np.cumsum(probs)
        cutoff = s[int((cum < p.top_p).sum())]
        x = np.where(x < cutoff, -np.inf, x)
    return np.isfinite(x)


def _top2_margin(rows):
    top = np.sort(rows, axis=-1)[:, ::-1]
    return float((top[:, 0] - top[:, 1]).min())


def test_top_k_geq_vocab_equals_disabled_bitwise():
    """top_k >= vocab is the program of top_k = 0: under one generator
    state the three encodings draw the same tokens."""
    logits = torch.from_numpy(_logits(0, 4, 97))
    lanes = [_stack([SamplingParams(temperature=1.0, top_k=k)] * 4) for k in (97, 0, 500)]
    for seed in range(16):
        draws = [sample_lanes(_gen(seed), logits, ln) for ln in lanes]
        torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
        torch.testing.assert_close(draws[0], draws[2], rtol=0, atol=0)


def test_top_p_one_is_disabled_and_full_support():
    """top_p = 1 disables the nucleus: over a uniform 5-token vocabulary
    every token is drawn, through the filtered program and the plain one."""
    logits = torch.zeros((1, 5))
    lanes = _stack([SamplingParams(temperature=1.0, top_p=1.0)])
    seen_filtered, seen_plain = set(), set()
    for seed in range(64):
        seen_filtered.add(int(sample_lanes(_gen(seed), logits, lanes, use_filters=True)[0]))
        seen_plain.add(int(sample_lanes(_gen(seed), logits, lanes, use_filters=False)[0]))
    assert seen_filtered == seen_plain == set(range(5))


def test_temperature_near_zero_equals_argmax():
    """temperature -> 0+ is the argmax (the clamp shared with ``sample()``
    keeps the scaled logits finite); temperature 0 and greedy=True are the
    greedy encoding."""
    rows = _logits(3, 5, 211)
    assert _top2_margin(rows) > 1e-3
    logits, am = torch.from_numpy(rows), np.argmax(rows, axis=-1)
    for t in (0.0, 1e-30, 1e-12, 1e-7):
        lanes = _stack([SamplingParams(temperature=t)] * 5)
        for seed in range(4):
            got = sample_lanes(_gen(seed), logits, lanes)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), am, err_msg=f"t={t}")
    np.testing.assert_array_equal(sample_lanes(_gen(0), logits, _stack([SamplingParams(greedy=True)] * 5)).numpy(), am)


def test_temperature_epsilon_matches_reference_sample():
    """At tiny temperatures the port's single-lane ``sample`` and its
    per-lane path are the argmax, and the reference's ``sample`` lies in its
    own support: the same argmax."""
    rows = _logits(9, 3, 64)
    assert _top2_margin(rows) > 1e-3
    am = np.argmax(rows, axis=-1)
    for t in (1e-30, 1e-9):
        p = SamplingParams(temperature=t)
        got_one = sample(_gen(1), torch.from_numpy(rows), p).numpy()
        got_lanes = sample_lanes(_gen(1), torch.from_numpy(rows), lane_params(p, 3, device="cpu")).numpy()
        ref = np.asarray(jax_sample(jax.random.key(1), jnp.asarray(rows), _jax_params(p)))
        np.testing.assert_array_equal(got_one, am)
        np.testing.assert_array_equal(got_lanes, am)
        assert all(_ref_allowed(rows[i], p)[ref[i]] for i in range(3))


def test_mixed_greedy_filtered_lanes_match_reference_support():
    """One sampling pass, four lane policies: every draw of either package
    lands in that lane's reference support, and the greedy lane is the
    argmax for every seed."""
    ps = [SamplingParams(greedy=True), SamplingParams(temperature=0.8, top_k=3),
          SamplingParams(temperature=1.1, top_p=0.7), SamplingParams(temperature=2.0)]
    rows = _logits(7, len(ps), 89)
    allowed = [_ref_allowed(rows[i], p) for i, p in enumerate(ps)]
    lanes, jlanes = _stack(ps), jax_stack([_jax_params(p) for p in ps])
    am0 = int(np.argmax(rows[0]))
    for seed in range(64):
        got = sample_lanes(_gen(seed), torch.from_numpy(rows), lanes).numpy()
        ref = np.asarray(jax_sample_lanes(jax.random.key(seed), jnp.asarray(rows), jlanes))
        assert int(got[0]) == am0 == int(ref[0])
        for i in range(len(ps)):
            assert allowed[i][got[i]] and allowed[i][ref[i]], (seed, i, got[i], ref[i])
    # the filters bite: top_k = 3 keeps three tokens, the nucleus fewer than all
    assert allowed[1].sum() == 3 and 0 < allowed[2].sum() < 89


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=2**20),
    v=st.integers(min_value=4, max_value=160),
    temp=st.sampled_from([0.0, 1e-9, 1e-6, 0.3, 1.0, 2.5]),
    top_k=st.sampled_from([0, 1, 3, 7, 1000]),
    top_p=st.sampled_from([1.0, 0.9, 0.4, 1e-6]),
)
def test_property_draws_stay_in_reference_support(seed, v, temp, top_k, top_p):
    p = SamplingParams(temperature=temp, top_k=top_k, top_p=top_p)
    rows = _logits(seed, 2, v)
    got = sample_lanes(_gen(seed ^ 0x5EED), torch.from_numpy(rows),
                       _stack([p, SamplingParams(greedy=True)])).numpy()
    allowed = _ref_allowed(rows[0], p)
    assert allowed[got[0]], (got[0], np.flatnonzero(allowed))
    assert int(got[1]) == int(np.argmax(rows[1]))

