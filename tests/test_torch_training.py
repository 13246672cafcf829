"""The port's optimizer, schedules, loss, checkpoints, data pipeline and
training entry points: the counterparts of ``tests/test_training.py``'s
nine cases, each held against the JAX package where both compute the same
thing, and the port's own launcher and example on the CPU.

Tolerances: ``adamw_update`` on identical numpy gradients rtol = 1e-6,
atol = 1e-7 over several steps (the same f32 arithmetic in the same order;
XLA and torch may round ``pow`` and ``cos`` an ulp apart); the schedule
rtol = 1e-6. The sampler cases hold on support and determinism, not on
the reference's ``rbg`` key chain, which torch cannot replay.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import hypothesis_tools

given, settings, st = hypothesis_tools()  # stubs skip ONLY the property tests

from repro import configs as jconfigs
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, batch_to, make_batch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.examples import train_small_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tmodel
from repro_torch.serving.sampler import SamplingParams, sample
from repro_torch.training.optimizer import AdamWConfig, adamw_update, global_norm, init_adamw, lr_at
from repro_torch.training.trainer import (abstract_train_state, init_train_state, make_eval_step,
                                          make_train_step, train_state)

ARCHS = list(jconfigs.ARCHS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the nine cases of tests/test_training.py
# ---------------------------------------------------------------------------
def test_loss_decreases_smollm():
    cfg = get_config("smollm-135m", reduced=True)
    state = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    losses = []
    for i in range(25):
        state, m = step(state, batch_to(make_batch(cfg, DataConfig(seq_len=64, batch_size=8, seed=i)), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(grad_clip=1.0, lr=1.0, warmup_steps=0, total_steps=10, schedule="constant")
    params = {"w": torch.ones((4, 4))}
    new, _, metrics = adamw_update(cfg, params, {"w": torch.full((4, 4), 1e6)}, init_adamw(params))
    # the raw norm is reported, not the clipped one
    assert float(metrics["grad_norm"]) > 1e5
    np.testing.assert_allclose(float(metrics["grad_norm"]), 4e6, rtol=1e-6)
    # and the step is Adam's with the clipped gradient: -lr * (1 + decay)
    jnew, _, _ = jopt.adamw_update(jopt.AdamWConfig(**dataclasses.asdict(cfg)), {"w": jnp.ones((4, 4))},
                                   {"w": jnp.full((4, 4), 1e6)}, jopt.init_adamw({"w": jnp.ones((4, 4))}))
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]), rtol=1e-6, atol=1e-7)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(lr_at(cfg, torch.tensor(s))) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_equals_the_reference(schedule):
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1), dict(lr=3e-4, warmup_steps=0),
               dict(lr=3e-3, warmup_steps=20, total_steps=20)):
        cfg = AdamWConfig(schedule=schedule, **kw)
        jcfg = jopt.AdamWConfig(schedule=schedule, **kw)
        steps = np.arange(0, 130, 7, dtype=np.int32)
        got = np.array([float(lr_at(cfg, torch.tensor(int(s), dtype=torch.int32))) for s in steps])
        want = np.array([float(jopt.lr_at(jcfg, jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_weight_decay_only_on_matrices():
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0, grad_clip=0, warmup_steps=0, total_steps=10, schedule="constant")
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    grads = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    new, _, _ = adamw_update(cfg, params, grads, init_adamw(params))
    assert float(new["w"].max()) < 1.0   # decayed
    assert float(new["b"].min()) == 1.0  # exempt


def test_checkpoint_roundtrip_nested(tmp_path):
    pytest.importorskip("zstandard")  # the zstd file codec is optional, as in the reference
    cfg = get_config("qwen3-4b", reduced=True)
    state = init_train_state(cfg, seed=0, device="cpu")
    path = str(tmp_path / "ck.msgpack.zst")
    ckpt.save(path, state)
    restored = ckpt.load(path, state)
    a, b = ckpt.tree_flatten_with_path(state), ckpt.tree_flatten_with_path(restored)
    assert [k for k, _ in a] == [k for k, _ in b] and any(k.startswith(".opt.m") for k, _ in a)
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y)


def test_stored_checkpoint_is_read_by_the_reference(tmp_path):
    """``save_framed`` stores (zlib level 0: f32 weights hardly compress):
    the file is about the payload's size, and the reference's
    ``loads_framed`` reads it back bitwise."""
    from repro.checkpoint import io as jio

    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((64, 32)).astype(np.float32), "b": [np.arange(5, dtype=np.int32)]}
    path = tmp_path / "t.wcsb"
    ckpt.save_framed(str(path), tmodel.tree_map(torch.from_numpy, tree))
    assert path.stat().st_size >= 64 * 32 * 4
    back = jio.loads_framed(path.read_bytes(), tree)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])


def test_corpus_deterministic_and_learnable_structure():
    c1 = SyntheticCorpus(DataConfig(seq_len=32, batch_size=4, seed=7))
    c2 = SyntheticCorpus(DataConfig(seq_len=32, batch_size=4, seed=7))
    b1, b2 = c1.batch(), c2.batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].max() < 256
    flat = b1["tokens"].flatten()
    assert (flat == ord("|")).sum() >= 0


def test_tokenizer_roundtrip():
    tok = ByteTokenizer(512)
    for text in ["hello", "[TASK: xyz]", "ünïcødé"]:
        assert tok.decode(tok.encode(text)) == text


@settings(max_examples=20, deadline=None)
@given(temp=st.floats(0.1, 2.0), k=st.integers(1, 10), seed=st.integers(0, 1000))
def test_sampler_topk_support(temp, k, seed):
    logits = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 32)).astype(np.float32))
    params = SamplingParams(temperature=temp, top_k=k)
    t = sample(torch.Generator().manual_seed(seed + 1), logits, params)
    topk_sets = torch.topk(logits, k).indices
    for b in range(2):
        assert int(t[b]) in topk_sets[b].tolist()
    again = sample(torch.Generator().manual_seed(seed + 1), logits, params)
    assert torch.equal(t, again)  # the same generator state, the same tokens


def test_sampler_greedy():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    t = sample(torch.Generator().manual_seed(0), logits, SamplingParams(greedy=True))
    assert int(t[0]) == 1


# ---------------------------------------------------------------------------
# AdamW against the reference on identical gradients
# ---------------------------------------------------------------------------
def _stacked_tree(rng):
    """A small tree shaped as the port's params: stacked [L, d] norm scales
    and biases, [L, d, f] matrices, an unstacked [d] final norm."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"groups": [{"ln1": 1.0 + 0.1 * f(2, 8), "attn": {"wq": f(2, 8, 8), "bq": f(2, 8)}}],
            "embed": f(16, 8), "final_norm": 1.0 + 0.1 * f(8)}


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_matches_the_reference(schedule, grad_clip):
    """Four steps on the same numpy gradients (large enough that clipping
    bites when it is on): params, moments, step, norm and lr."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip, warmup_steps=2, total_steps=6, schedule=schedule)
    params = _stacked_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), tmodel.tree_map(torch.from_numpy, params)
    js, ts = jopt.init_adamw(jp), init_adamw(tp)
    for _ in range(4):
        g = jax.tree.map(lambda a: 3.0 * rng.standard_normal(a.shape).astype(np.float32), params)
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**kw), jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = adamw_update(AdamWConfig(**kw), tp, tmodel.tree_map(torch.from_numpy, g), ts)
        for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            ours, ref = ckpt.tree_flatten_with_path(tree_t), jax.tree_util.tree_flatten_with_path(tree_j)[0]
            assert [k for k, _ in ours] == [jax.tree_util.keystr(k) for k, _ in ref]  # JAX's leaf order
            for (k, a), (_, b) in zip(ours, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=k)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    if grad_clip:
        assert float(tm["grad_norm"]) > grad_clip  # the clip bit


def test_stacked_norms_and_biases_are_decayed_as_in_the_reference():
    """The reference decays every leaf with ndim >= 2; its layer leaves are
    stacked on a layer axis, so the stacked norm scales (ln1, ln2) and qkv
    biases ([L, d]) are decayed, though its comment exempts norms and
    biases. The port keeps that rule for parity: with zero gradients, the
    stacked [L, d] leaves shrink by lr * wd in both packages, and the
    unstacked final norm [d] does not move."""
    jcfg = jconfigs.get_config("qwen2.5-0.5b", reduced=True)
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    jparams = jtrainer.init_train_state(jax.random.key(0), jcfg).params
    tparams = train_state(bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")).params
    kw = dict(lr=0.1, weight_decay=0.5, grad_clip=0.0, warmup_steps=0, total_steps=10, schedule="constant")
    jnew, _, _ = jax.jit(lambda p: jopt.adamw_update(jopt.AdamWConfig(**kw), p, jax.tree.map(jnp.zeros_like, p),
                                                     jopt.init_adamw(p)))(jparams)
    tnew, _, _ = adamw_update(AdamWConfig(**kw), tparams, tmodel.tree_map(torch.zeros_like, tparams),
                              init_adamw(tparams))
    g0, jg0 = tnew["groups"][0], jnew["groups"][0]
    for name, t, j, old in (("ln1", g0["ln1"], jg0["ln1"], tparams["groups"][0]["ln1"]),
                            ("ln2", g0["ln2"], jg0["ln2"], tparams["groups"][0]["ln2"]),
                            ("bq", g0["attn"]["bq"], jg0["attn"]["bq"], tparams["groups"][0]["attn"]["bq"])):
        assert t.dim() == 2, name
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(t.detach().numpy(), old.detach().numpy() * (1 - 0.1 * 0.5), rtol=1e-6,
                                   err_msg=name)
    assert torch.equal(tnew["final_norm"].detach(), tparams["final_norm"].detach())
    np.testing.assert_array_equal(np.asarray(jnew["final_norm"]), np.asarray(jparams["final_norm"]))


def test_global_norm_and_eval_step():
    cfg = dataclasses.replace(get_config("smollm-135m", reduced=True), compute_dtype="float32")
    state = init_train_state(cfg, seed=0, device="cpu")
    batch = batch_to(make_batch(cfg, DataConfig(seq_len=16, batch_size=2)), "cpu")
    m = make_eval_step(cfg)(state.params, batch)
    assert not m["loss"].requires_grad and torch.isfinite(m["loss"])
    _, tm = make_train_step(cfg, AdamWConfig())(state, batch)
    assert float(tm["loss"]) == float(m["loss"])
    tree = {"a": torch.full((3,), 2.0), "b": [torch.full((2, 2), 1.0)]}
    assert float(global_norm(tree)) == pytest.approx(4.0)


# ---------------------------------------------------------------------------
# the abstract state on the meta device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_equals_the_reference(arch):
    """Every leaf of the full config's state, params and Adam moments and
    both step counters: the reference's shape and dtype, with no memory."""
    ref = jax.tree_util.tree_flatten_with_path(jtrainer.abstract_train_state(jconfigs.get_config(arch)))[0]
    ours = abstract_train_state(get_config(arch))
    got = ckpt.tree_flatten_with_path(ours)
    assert [k for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref]
    for (k, a), (_, b) in zip(got, ref):
        assert a.device.type == "meta", k
        assert tuple(a.shape) == b.shape and ckpt.dtype_name(a.dtype) == str(b.dtype), k


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------
def test_launcher_trains_and_checkpoints_on_the_cpu(tmp_path):
    out = launch_train.main(["--device", "cpu", "--steps", "3", "--seq", "32", "--batch", "4",
                             "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    assert out["device"] == "cpu" and out["steps"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"])) and np.isfinite(out["final"]["grad_norm"])
    assert [os.path.basename(p) for p in out["checkpoints"]] == ["step1.wcsb", "step2.wcsb"]
    cfg = get_config("smollm-135m", reduced=True)
    like = tmodel.init_params(cfg, device="cpu")
    restored = ckpt.load_framed(out["checkpoints"][-1], like)
    got, want = ckpt.tree_flatten_with_path(restored), ckpt.tree_flatten_with_path(like)
    assert [(k, a.shape) for k, a in got] == [(k, a.shape) for k, a in want]
    # the production mesh on a world of one: the same run, checkpoints gathered whole
    mesh = launch_train.main(["--device", "cpu", "--steps", "3", "--seq", "32", "--batch", "4", "--mesh", "single",
                              "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "mesh")])
    assert mesh["mesh"] == (1, 1) and mesh["losses"] == out["losses"]
    again = ckpt.tree_flatten_with_path(ckpt.load_framed(mesh["checkpoints"][-1], like))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(again, got))


def test_example_trains_checkpoints_and_serves_on_the_cpu(tmp_path):
    out = train_small_lm.main(["--device", "cpu", "--steps", "3", "--ckpt", str(tmp_path / "lm.wcsb")])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["ckpt_bytes"] > 0
    got, want = ckpt.tree_flatten_with_path(out["restored"]), ckpt.tree_flatten_with_path(out["params"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert torch.equal(a, b.detach())  # the round trip is bitwise
    assert [s["prompt"] for s in sorted(out["samples"], key=lambda s: s["prompt"])] == ["12+34=", "abcde|"]
    assert all(len(s["tokens"]) > 0 for s in out["samples"])
