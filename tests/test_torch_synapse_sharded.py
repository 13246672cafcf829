"""The port's ``core.synapse_sharded`` against the reference's: the eight
cases of ``tests/test_synapse_sharded.py``, on the same numpy inputs, f32.

* the one-hot write and read (the exact scatter and gather with no token
  axis, the one-hot select and contraction with one) equal the reference's
  and each other bitwise;
* ``piece_attend`` with no axis is one ``synapse_attention`` call, within
  1e-5 of the reference's ``decode_attend`` and ``piece_attend``;
* ``token_sharding`` scopes are leak-proof and an explicit context wins;
* an axis without a mesh is refused;
* the flash-decode combine over 2 gloo ranks (each holding half of every
  piece's keys; a job of ``torch_lane_jobs``) equals the local path and
  the reference's ``piece_attend`` with no axis within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lane_jobs as jobs
from repro.core import synapse_sharded as jsh
from repro.models.attention import decode_attend as jax_decode_attend
from repro_torch.core import synapse_sharded as sh
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The 2-rank piece_attend job, started when the module starts."""
    return jobs.Ranks(jobs.piece_attend_job, 2, tmp_path_factory.mktemp("piece"), seed=7)


def test_onehot_write_read_roundtrip():
    buf = np.zeros((3, 8, 2, 4), np.float32)
    new = np.ones((3, 2, 4), np.float32) * np.arange(1, 4, dtype=np.float32)[:, None, None]
    slot = np.asarray([0, 3, 7], np.int32)
    out = sh.onehot_write(torch.from_numpy(buf.copy()), torch.from_numpy(slot), torch.from_numpy(new))
    back = sh.onehot_read(out, torch.from_numpy(slot))
    np.testing.assert_array_equal(back.numpy(), new)
    assert float(out.sum()) == float(new.sum())  # untouched slots stay zero
    want = jsh.onehot_write(jnp.asarray(buf), jnp.asarray(slot), jnp.asarray(new))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_onehot_write_mask():
    buf = torch.zeros((2, 4))
    out = sh.onehot_write(buf, torch.tensor([1, 2]), torch.tensor([5.0, 7.0]), mask=torch.tensor([True, False]))
    assert float(out[0, 1]) == 5.0 and float(out[1, 2]) == 0.0
    want = jsh.onehot_write(jnp.zeros((2, 4)), jnp.asarray([1, 2]), jnp.asarray([5.0, 7.0]),
                            mask=jnp.asarray([True, False]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _pieces(seed=0, B=2, H=8, Hkv=4, D=32, sizes=(16, 8, 4)):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = n(B, H, D)
    pieces, valids = [], []
    for T in sizes:
        pieces.append((n(B, T, Hkv, D), n(B, T, Hkv, D)))
        valid = rng.uniform(size=(B, T)) < 0.8
        valid[:, 0] = True
        valids.append(valid)
    return q, pieces, valids


def test_piece_attend_matches_decode_attend():
    q, pieces, valids = _pieces()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    before = ops.KERNELS["synapse_attention"].launches
    out, masses = sh.piece_attend(torch.from_numpy(q), [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in pieces],
                                  [torch.from_numpy(m) for m in valids], scale)
    assert ops.KERNELS["synapse_attention"].launches == before  # the CPU runs the plain version
    out_ref, mass_ref = jax_decode_attend(jnp.asarray(q), jnp.asarray(np.concatenate([k for k, _ in pieces], 1)),
                                          jnp.asarray(np.concatenate([v for _, v in pieces], 1)),
                                          jnp.asarray(np.concatenate(valids, 1)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
    np.testing.assert_allclose(torch.cat(masses, 1).numpy(), np.asarray(mass_ref), **TOL)
    out_j, masses_j = jsh.piece_attend(jnp.asarray(q), [(jnp.asarray(k), jnp.asarray(v)) for k, v in pieces],
                                       [jnp.asarray(m) for m in valids], scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    for a, b in zip(masses, masses_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_token_sharding_scope_is_leak_proof():
    """The context manager restores the previous placement on exit and on
    error."""
    assert sh.get_shard_axis() is None
    with sh.token_sharding("model", mesh="fake-mesh"):
        assert sh.get_shard_axis() == "model"
        assert sh.current_context().mesh == "fake-mesh"
        with sh.token_sharding(None):  # nested scopes override and restore
            assert sh.get_shard_axis() is None
        assert sh.get_shard_axis() == "model"
    assert sh.get_shard_axis() is None
    with pytest.raises(RuntimeError):
        with sh.token_sharding("model"):
            raise RuntimeError("boom")
    assert sh.get_shard_axis() is None


def test_explicit_ctx_overrides_ambient_scope():
    """An explicit local context under a sharded scope takes the exact
    scatter and gather."""
    buf = torch.zeros((3, 8, 2, 4))
    new = torch.ones((3, 2, 4))
    slot = torch.tensor([0, 3, 7])
    local = sh.ShardContext()
    with sh.token_sharding("model", mesh="fake-mesh"):
        out = sh.onehot_write(buf, slot, new, ctx=local)
        back = sh.onehot_read(out, slot, ctx=local)
    np.testing.assert_array_equal(back.numpy(), new.numpy())


def test_onehot_sharded_formulation_matches_scatter():
    """The one-hot select and contraction (a token axis live, no collective
    needed, so no mesh) equal the scatter and gather bitwise on in-bounds
    slots, and the reference's one-hot path."""
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((4, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((4, 2, 4)).astype(np.float32)
    slot, mask = np.asarray([0, 5, 7, 2], np.int32), np.asarray([True, False, True, True])
    oh_ctx = sh.ShardContext(axis="model")
    a = sh.onehot_write(torch.from_numpy(buf.copy()), torch.from_numpy(slot), torch.from_numpy(new),
                        mask=torch.from_numpy(mask))
    b = sh.onehot_write(torch.from_numpy(buf.copy()), torch.from_numpy(slot), torch.from_numpy(new),
                        mask=torch.from_numpy(mask), ctx=oh_ctx)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jsh.onehot_write(jnp.asarray(buf), jnp.asarray(slot), jnp.asarray(new), mask=jnp.asarray(mask),
                            ctx=jsh.ShardContext(axis="model"))
    np.testing.assert_array_equal(b.numpy(), np.asarray(want))
    t = torch.from_numpy(buf)
    np.testing.assert_array_equal(sh.onehot_read(t, torch.from_numpy(slot)).numpy(),
                                  sh.onehot_read(t, torch.from_numpy(slot), ctx=oh_ctx).numpy())


def test_piece_attend_requires_mesh_with_axis():
    q = torch.zeros((1, 4, 8))
    k = torch.zeros((1, 4, 2, 8))
    valid = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="no mesh"):
        sh.piece_attend(q, [(k, k)], [valid], 0.5, ctx=sh.ShardContext(axis="model"))


def test_piece_attend_sharded_matches_local(sharded_run):
    """Two gloo ranks, each holding half of every piece's keys: the
    flash-decode combine (local max and sum, all-reduced) equals the local
    path and the reference's piece_attend with no axis (the combine
    reorders the softmax's reductions)."""
    q, pieces, valids = jobs.sharded_inputs(7)
    scale = 1.0 / q.shape[-1] ** 0.5
    out_l, mass_l = sh.piece_attend(q, pieces, valids, scale)
    out_j, mass_j = jsh.piece_attend(jnp.asarray(q.numpy()), [(jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
                                                              for k, v in pieces],
                                     [jnp.asarray(m.numpy()) for m in valids], scale)
    ranks = sharded_run.results()
    for r in ranks:
        np.testing.assert_allclose(r["out"], out_l.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["out"], np.asarray(out_j), **TOL)
    for i, (ml, mj) in enumerate(zip(mass_l, mass_j)):
        # each rank returns the mass of its own half of the piece's keys
        got = np.concatenate([r["masses"][i] for r in ranks], axis=1)
        np.testing.assert_allclose(got, ml.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(mj), **TOL)
