import dataclasses

import jax
import pytest

from repro.configs import get_config
from repro.models import model as model_lib


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); skips without one"
    )


def hypothesis_tools():
    """(given, settings, st) — real hypothesis when installed, else stubs
    that mark only the property tests skipped so the plain tests in the
    same module keep running (the container may lack hypothesis)."""
    try:
        from hypothesis import given, settings, strategies as st
        return given, settings, st
    except ImportError:
        class _Strategies:
            def __getattr__(self, name):
                return lambda *a, **k: None

        def given(*a, **k):
            return lambda f: pytest.mark.skip(reason="hypothesis not installed")(f)

        def settings(*a, **k):
            return lambda f: f

        return given, settings, _Strategies()


@pytest.fixture(autouse=True)
def _no_act_sharding():
    # tests run on the single CPU device; disable launch-time constraints
    model_lib.set_activation_sharding(None)
    yield
    model_lib.set_activation_sharding(None)


def reduced_fp32(arch: str):
    return dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")


def tiny_params(arch: str, seed: int = 0):
    cfg = reduced_fp32(arch)
    return cfg, model_lib.init_params(jax.random.key(seed), cfg)
