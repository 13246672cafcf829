"""The hand-written Mamba2 decode step's wrapper on the CPU: its check of
shapes, dtypes and contiguity, which the launch relies on, and the routing
that leaves CPU tensors on the plain step. The kernel itself runs on the
card only (``tests/test_torch_cuda.py``)."""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import mamba2_step, ops
from repro_torch.models import cache as cache_lib
from repro_torch.models import mamba2


def _operands(cfg, B=3, dtype=torch.float32):
    """A step's operands at ``cfg``'s widths, zeros: the in-projected row,
    the lane's state, and the mixer's small parameters (the serving casts
    put them all in the working type)."""
    st = cache_lib.init_mamba2_state(cfg, B, dtype, device="cpu")
    di, nh = cfg.ssm_d_inner, cfg.ssm_n_heads
    ch = di + 2 * cfg.ssm_ngroups * cfg.ssm_state_size
    z = lambda *s: torch.zeros(s, dtype=dtype)
    return dict(zxbcdt=z(B, di + ch + nh), conv_state=st.conv, ssm_state=st.ssm, conv_w=z(cfg.ssm_conv_width, ch),
                conv_b=z(ch), dt_bias=z(nh), a_log=z(nh), d_skip=z(nh), gate_norm=z(di))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch, reduced, want", [
    ("zamba2-1.2b", False, (3, 64, 64, 64, 1, 4)), ("zamba2-7b", False, (3, 112, 64, 64, 2, 4)),
    # the reduced variants that serve and the examples run on the card: heads of 32, a state of 16
    ("zamba2-1.2b", True, (3, 16, 32, 16, 1, 4)), ("zamba2-7b", True, (3, 16, 32, 16, 2, 4)),
])
def test_the_check_takes_both_zamba2_configs(arch, reduced, want, dtype):
    assert mamba2_step.step_shapes(**_operands(get_config(arch, reduced=reduced), dtype=dtype)) == want


def _widths(**kw):
    return lambda: _operands(dataclasses.replace(get_config("zamba2-7b", reduced=True), **kw))


def _groups_of_three():
    o = _operands(get_config("zamba2-7b"))  # 112 heads: three groups do not divide them
    o["conv_state"] = torch.zeros((3, 3, 112 * 64 + 2 * 3 * 64))
    return o


def _edit(name, fn):
    def make():
        o = _operands(get_config("zamba2-7b"))
        o[name] = fn(o[name])
        return o
    return make


@pytest.mark.parametrize("make, error, match", [
    (_widths(ssm_head_dim=128), ValueError, "heads of 128"),
    (_widths(ssm_head_dim=8), ValueError, "heads of 8"),
    (_widths(ssm_state_size=128), ValueError, "a state of 128"),
    (_groups_of_three, ValueError, "do not divide"),
    (_edit("ssm_state", lambda t: t.to(torch.bfloat16)), TypeError, "ssm_state"),
    (_edit("zxbcdt", lambda t: t.half()), TypeError, "zxbcdt"),
    (_edit("conv_state", lambda t: t.to(torch.bfloat16)), TypeError, "conv_state"),
    (_edit("a_log", lambda t: t.double()), TypeError, "a_log"),
    (lambda: {**_operands(get_config("zamba2-7b"), dtype=torch.bfloat16), "a_log": torch.zeros(112)}, TypeError,
     "a_log is torch.float32"),
    (_edit("ssm_state", lambda t: t.transpose(2, 3)), ValueError, "contiguous"),
    (_edit("conv_state", lambda t: t[:, :, :-1]), ValueError, "contiguous"),
    (_edit("conv_state", lambda t: torch.zeros((3, 4, t.shape[2]))), ValueError, "conv width"),
    (_edit("gate_norm", lambda t: t[:-64].clone()), ValueError, "gate_norm"),
    (_edit("zxbcdt", lambda t: t[:, :-1].clone()), ValueError, "zxbcdt"),
], ids=["head_dim_128", "head_dim_8", "state_128", "groups_of_three", "bf16_state", "fp16_row", "mixed_tail", "f64_param", "f32_param_bf16_step",
        "transposed_state", "strided_tail", "conv_width_5", "short_gate", "short_row"])
def test_the_check_refuses_what_the_kernel_does_not_take(make, error, match):
    with pytest.raises(error, match=match):
        mamba2_step.step_shapes(**make())


def test_the_wrapper_refuses_cpu_tensors_and_launches_nothing():
    before = mamba2_step.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        mamba2_step.mamba2_step(**_operands(get_config("zamba2-7b")), eps=1e-5)
    assert mamba2_step.KERNEL.launches == before
    assert ops.KERNELS["mamba2_step"] is mamba2_step.KERNEL


def test_cpu_tensors_take_the_plain_step_with_a_new_state():
    """On the CPU the decode returns a new state and leaves the cache's
    tensors as they were (the model's decode copies it in), through the
    plain step, with no launch."""
    cfg = get_config("zamba2-7b", reduced=True)
    g = torch.Generator().manual_seed(0)
    p = mamba2.mamba2_init(g, cfg, torch.float32, "cpu")
    state = cache_lib.init_mamba2_state(cfg, 2, torch.float32, device="cpu")
    state.ssm.normal_(generator=g)
    before = [t.clone() for t in (state.conv, state.ssm)]
    launches = mamba2_step.KERNEL.launches
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    y, new = mamba2.mamba2_decode(p, cfg, x, state)
    assert new is not state and y.shape == (2, 1, cfg.d_model)
    assert torch.equal(state.conv, before[0]) and torch.equal(state.ssm, before[1])
    assert not torch.equal(new.ssm, before[1])
    assert mamba2_step.KERNEL.launches == launches
    # the same numbers as the plain step called on its own
    zx = x[:, 0] @ p["w_in"]
    small = [p[n] for n in ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "gate_norm")]
    y_p, conv_p, ssm_p = mamba2.decode_plain(zx, state.conv, state.ssm, *small, cfg=cfg)
    assert torch.equal(new.conv, conv_p) and torch.equal(new.ssm, ssm_p) and torch.equal(y[:, 0], y_p @ p["w_out"])


def _reader(name):
    path = Path(__file__).resolve().parents[1] / "cortex_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stats,want", [
    ({"mamba_steps": 16200, "mamba_kernel_steps": 16200}, 100.0),
    ({"mamba_steps": 400, "mamba_kernel_steps": 100}, 25.0),
    ({"ticks": 40}, None),  # a program without the counters
    ({"mamba_steps": 0, "mamba_kernel_steps": 0}, None),  # no Mamba2 layer
])
def test_mamba_kernel_step_pct_reader(stats, want):
    assert _reader("mamba_kernel_step_pct.agents")(SimpleNamespace(engine={"stats": stats})) == want
