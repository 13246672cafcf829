"""The served weights: every leaf of every architecture the port holds is
drawn, in the layout's shapes and dtypes, and the same seed gives the same
tree; the dense model's draw is pinned."""
import pytest
import torch

from cortex_bench.weights import make_weights

SEED = 2**31 + 4093


def leaves(t, path=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, t


def _archs():
    from repro_torch.configs import ARCHS

    return list(ARCHS)


@pytest.mark.parametrize("arch", _archs())
def test_every_leaf_of_every_configuration_is_drawn(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import abstract_params

    cfg = get_config(arch, reduced=True)
    want = [(p, tuple(t.shape), t.dtype) for p, t in leaves(abstract_params(cfg))]
    got = list(leaves(make_weights(cfg, SEED, torch.device("cpu"))))
    assert [(p, tuple(t.shape), t.dtype) for p, t in got] == want
    assert all(bool(torch.isfinite(t).all()) for _, t in got)
    again = leaves(make_weights(cfg, SEED, torch.device("cpu")))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, again))


def test_the_dense_draw_is_pinned():
    # sums over reduced qwen2.5-0.5b's leaves, each weighted by its place in
    # the walk: a changed kind, scale or walk order moves them
    from repro_torch.configs import get_config

    w = [t for _, t in leaves(make_weights(get_config("qwen2.5-0.5b", reduced=True), SEED, torch.device("cpu")))]
    assert len(w) == 14 and sum(t.numel() for t in w) == 1_313_024
    s1 = sum((k + 1) * float(t.double().sum()) for k, t in enumerate(w))
    s2 = sum((k + 1) * float(t.double().square().sum()) for k, t in enumerate(w))
    assert s1 == pytest.approx(6011.794326542453, rel=1e-6)
    assert s2 == pytest.approx(44754.74139118447, rel=1e-6)
