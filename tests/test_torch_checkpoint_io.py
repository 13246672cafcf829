"""The port's tree codec and framed blob format against the JAX package's
(``repro_torch.checkpoint.io`` vs ``repro.checkpoint.io``).

* CODEC — the cases of tests/test_checkpoint_io.py on the port: bitwise
  round trips over every dtype a snapshot holds (bf16 included), restores
  into (shape, dtype) skeletons, KeyError on a missing leaf, zstd gated.
* FRAMES — the framed cases of tests/test_resilience.py: round trip with
  metadata, truncation anywhere, every single bit flip, ``read_frame_meta``.
* BYTES — the port's payload equals the reference ``_encode_tree``'s bytes
  on the same tree, and the whole frame is byte-equal under zlib + crc32
  (the card host's codec: it has no zstandard or xxhash).
* INTERCHANGE — a blob written by either package's ``dumps_framed`` is read
  by the other's ``loads_framed``, for an f32 and a bf16 snapshot of a
  reduced river lane and side lane.
"""
import dataclasses
import pickle
import zlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jax_get_config
from repro.core import engine as jengine
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.sampler import SamplingParams as JaxSampling
from repro_torch import bridge
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.sampler import SamplingParams

needs_zstd = pytest.mark.skipif(tio.zstandard is None, reason="zstandard not installed")


def _mixed_tree(seed: int = 0):
    """Nested dict/list/tuple tree over every dtype family a snapshot holds:
    f32 and bf16 caches, int32 tokens, bool masks, int64 scalars."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    return {
        "caches": [
            {"k": r(3, 1, 4, 2), "v": r(3, 1, 4, 2).to(torch.bfloat16)},
            {"k": r(2, 5).to(torch.float16), "v": r(2, 5).to(torch.float64)},
        ],
        "tok": torch.tensor(17, dtype=torch.int32),
        "pos": torch.tensor(123456789, dtype=torch.int64),
        "mask": torch.rand(7, generator=g) > 0.5,
        "pair": (torch.arange(6, dtype=torch.uint8).reshape(2, 3), torch.tensor([-1, 0, 1], dtype=torch.int16)),
    }


def _leaves(tree):
    return [leaf for _, leaf in tio.tree_flatten_with_path(tree)]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = tio.as_tensor(x), tio.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert tio.leaf_bytes(x) == tio.leaf_bytes(y)  # bitwise, NaN payloads included


def _skeleton(tree):
    return tio.tree_map(tio.spec_of, tree)


# ---------------------------------------------------------------------------
# the codec (tests/test_checkpoint_io.py)
# ---------------------------------------------------------------------------
def test_raw_codec_roundtrip_bitwise():
    tree = _mixed_tree()
    back = tio._decode_tree(tio._encode_tree(tree), tree)
    _assert_bitwise(tree, back)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in _leaves(back))
    assert isinstance(back["pair"], tuple) and isinstance(back["caches"], list)


def test_raw_codec_restores_into_skeleton():
    """``like`` may be all (shape, dtype) records: the cold tier keeps only
    the skeleton in memory, never the tensors."""
    tree = _mixed_tree(1)
    skel = _skeleton(tree)
    assert all(isinstance(x, tio.LeafSpec) for x in _leaves(skel))
    _assert_bitwise(tree, tio._decode_tree(tio._encode_tree(tree), skel))


def test_raw_codec_numpy_leaves():
    """numpy leaves (scalars included) encode as their tensors do."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 2)).astype(np.float32), "b": np.int32(7), "c": np.arange(4, dtype=np.int64)}
    back = tio._decode_tree(tio._encode_tree(tree), tree)
    for k, v in tree.items():
        assert back[k].numpy().dtype == np.asarray(v).dtype
        assert back[k].numpy().tobytes() == np.asarray(v).tobytes()


def test_missing_leaf_raises_keyerror():
    tree = _mixed_tree(3)
    raw = tio._encode_tree({"tok": tree["tok"]})
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        tio._decode_tree(raw, tree)


def test_extra_leaves_are_ignored():
    """A blob may carry more than the template asks for; decode selects by
    path."""
    tree = _mixed_tree(4)
    back = tio._decode_tree(tio._encode_tree(tree), {"tok": tree["tok"]})
    assert torch.equal(back["tok"], tree["tok"])


def test_dumps_requires_zstd_when_missing(monkeypatch):
    monkeypatch.setattr(tio, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        tio.dumps({"x": torch.zeros(2)})
    # the framed format falls back to zlib instead
    assert tio.default_codec() == tio.CODEC_ZLIB
    _assert_bitwise({"x": torch.ones(2)}, tio.loads_framed(tio.dumps_framed({"x": torch.ones(2)}), {"x": torch.ones(2)}))


@needs_zstd
def test_dumps_loads_roundtrip_bitwise():
    tree = _mixed_tree(5)
    blob = tio.dumps(tree)
    assert isinstance(blob, bytes)
    _assert_bitwise(tree, tio.loads(blob, tree))
    _assert_bitwise(tree, tio.loads(blob, _skeleton(tree)))


@needs_zstd
def test_dumps_compresses_redundant_payloads():
    tree = {"z": torch.zeros((256, 256))}
    assert len(tio.dumps(tree)) < tree["z"].numel() * 4 // 10


@needs_zstd
def test_loads_missing_leaf_raises():
    blob = tio.dumps({"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        tio.loads(blob, {"a": torch.ones(3), "b": torch.ones(2, dtype=torch.int32)})


@needs_zstd
def test_save_load_file_roundtrip(tmp_path):
    tree = _mixed_tree(6)
    path = str(tmp_path / "nested" / "snap.zst")
    tio.save(path, tree)
    assert not (tmp_path / "nested" / "snap.zst.tmp").exists()  # atomic
    _assert_bitwise(tree, tio.load(path, tree))


def test_roundtrip_dataclass_tree():
    """Dataclass trees (the caches) survive: the key strings name the
    fields, and the decode rebuilds the dataclass."""

    @dataclasses.dataclass
    class Snap:
        k: torch.Tensor
        v: torch.Tensor

    tree = Snap(k=torch.arange(12, dtype=torch.float32).reshape(3, 4), v=torch.arange(4, dtype=torch.int32))
    assert [p for p, _ in tio.tree_flatten_with_path(tree)] == [".k", ".v"]
    back = tio.loads_framed(tio.dumps_framed(tree), _skeleton(tree))
    assert isinstance(back, Snap)
    _assert_bitwise(tree, back)


# ---------------------------------------------------------------------------
# frames (tests/test_resilience.py)
# ---------------------------------------------------------------------------
def _snap(seed, kb=4):
    g = torch.Generator().manual_seed(seed)
    return {"caches": torch.randn(kb * 256, generator=g), "tok": torch.tensor(seed, dtype=torch.int32),
            "pos": torch.tensor(seed * 10, dtype=torch.int64)}


def test_framed_roundtrip_bitwise_with_meta():
    tree = _snap(7)
    meta = pickle.dumps({"key": "x", "n": 3})
    blob = tio.dumps_framed(tree, meta=meta)
    assert tio.parse_frame_header(blob)["codec"] in (tio.CODEC_ZLIB, tio.CODEC_ZSTD)
    assert tio.unframe(blob)[0] == meta
    _assert_bitwise(tree, tio.loads_framed(blob, _skeleton(tree)))


def test_framed_catches_truncation_everywhere():
    blob = tio.dumps_framed(_snap(1), meta=b"m" * 17)
    for cut in (0, 3, tio.FRAME_HEADER_BYTES - 1, tio.FRAME_HEADER_BYTES,
                tio.FRAME_HEADER_BYTES + 5, len(blob) // 2, len(blob) - 1):
        with pytest.raises(tio.CorruptBlobError):
            tio.unframe(blob[:cut])
    with pytest.raises(tio.CorruptBlobError):  # oversize too
        tio.unframe(blob + b"x")


@pytest.mark.parametrize("codec,hash_id", [(None, None), (tio.CODEC_ZLIB, tio.HASH_CRC32)])
def test_framed_catches_every_single_bit_flip(codec, hash_id):
    """One bit flipped at EVERY byte offset: verification raises, or (bits
    no digest guards, such as the reserved header byte) the decode returns
    the original bytes. Silent wrong data is never possible."""
    tree = _snap(2, kb=1)
    skel = _skeleton(tree)
    blob = tio.dumps_framed(tree, meta=b"bookkeeping", codec=codec, hash_id=hash_id)
    for i in range(len(blob)):
        bad = bytearray(blob)
        bad[i] ^= 0x01
        try:
            got = tio.loads_framed(bytes(bad), skel)
        except tio.CorruptBlobError:
            continue
        _assert_bitwise(tree, got)


def test_read_frame_meta_cheap_and_checked(tmp_path):
    meta = pickle.dumps({"skeleton": "here"})
    blob = tio.dumps_framed(_snap(3), meta=meta)
    p = tmp_path / "x.blob"
    p.write_bytes(blob)
    assert tio.read_frame_meta(str(p)) == meta
    p.write_bytes(blob[: len(blob) - 10])  # truncated payload: the size check fires
    with pytest.raises(tio.CorruptBlobError):
        tio.read_frame_meta(str(p))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "héllo",
    b"x" * 255, b"y" * 256, b"z" * 65536,
    list(range(15)), list(range(16)), list(range(70000)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": [i, b"v"] for i in range(16)},
], ids=lambda v: f"{type(v).__name__}-{len(v) if hasattr(v, '__len__') else v}")
def test_packb_equals_msgpack_at_every_width(value):
    """The port's packer gives msgpack's bytes at every width boundary of
    the payload's types, and reads them back as msgpack does."""
    want = jio.msgpack.packb(value, use_bin_type=True)
    assert tio.packb(value) == want
    assert tio.unpackb(want) == jio.msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("bad", [b"\xc0", b"\xca\x00\x00\x00\x00", b"\xff", b"\x92\x01", b"\x01\x02"])
def test_unpackb_refuses_what_the_payload_never_holds(bad):
    """nil, floats, negative ints, a truncated array, trailing bytes."""
    with pytest.raises(ValueError):
        tio.unpackb(bad)


def test_unknown_leaf_dtype_is_corruption_not_a_missing_leaf():
    raw = tio.packb([{"path": "['x']", "dtype": "complex32", "shape": [1], "data": b"\0\0\0\0"}])
    blob = tio.frame(zlib.compress(raw), codec=tio.CODEC_ZLIB)
    with pytest.raises(tio.CorruptBlobError, match="undecodable"):
        tio.loads_framed(blob, {"x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# bytes and interchange against the JAX package
# ---------------------------------------------------------------------------
def _to_numpy(t: torch.Tensor):
    """A port leaf as the reference holds it (bf16 through ml_dtypes)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def lanes():
    """(JAX snapshots, port snapshots): a river lane and a side lane of the
    reduced Qwen2.5-0.5B after the same prompt and spawn in both packages,
    each in f32 and with its float leaves cast to bf16."""
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    kw = dict(n_main=2, max_side=2, main_capacity=64, inject_tokens=8, theta=-1.0, sync_every=4)
    jeng = JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size), sampling=JaxSampling(greedy=True), **kw)
    teng = CortexEngine(Prism(tp, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size),
                        sampling=SamplingParams(greedy=True), device="cpu", **kw)
    for eng in (jeng, teng):
        eng.submit("a river [TASK: and its side] lane", lane=0)
    j = {"main": jax.tree.map(np.asarray, jengine._gather_main_lane(jeng.state, 0)),
         "side": jax.tree.map(np.asarray, jengine._gather_side_lane(jeng.state, 0))}
    t = {"main": teng._gather_main_lane(0), "side": teng._gather_side_lane(0)}
    for k in ("main", "side"):
        j[k + "-bf16"] = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16) if a.dtype == np.float32 else a, j[k])
        t[k + "-bf16"] = tio.tree_map(lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a, t[k])
    return j, t


SNAPS = ["main", "side", "main-bf16", "side-bf16"]


def _port_values_in_reference_tree(j_tree, t_tree):
    """The reference's tree (its containers and dataclasses) holding the
    port's leaf values, leaf for leaf in flattening order."""
    leaves = [_to_numpy(tio.as_tensor(a).contiguous()) for _, a in tio.tree_flatten_with_path(t_tree)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(j_tree), leaves)


@pytest.mark.parametrize("snap", SNAPS)
def test_paths_and_dtypes_match_the_reference(lanes, snap):
    j, t = lanes
    jpaths = [(jax.tree_util.keystr(p), str(np.asarray(a).dtype), np.shape(a))
              for p, a in jax.tree_util.tree_flatten_with_path(j[snap])[0]]
    tpaths = [(p, tio.dtype_name(a.dtype), tuple(a.shape)) for p, a in tio.tree_flatten_with_path(t[snap])]
    assert tpaths == jpaths


@pytest.mark.parametrize("snap", SNAPS)
def test_payload_bytes_equal_the_reference(lanes, snap):
    """Same leaves, same bytes: the port's payload equals the reference
    ``_encode_tree`` (msgpack.packb) of the reference's lane tree holding
    the port's values, and the port's decoder reads msgpack's view of it."""
    j, t = lanes
    port = tio._encode_tree(t[snap])
    assert port == jio._encode_tree(_port_values_in_reference_tree(j[snap], t[snap]))
    assert tio.unpackb(port) == jio.msgpack.unpackb(port, raw=False)


def test_mixed_payload_bytes_equal_the_reference():
    tree = _mixed_tree(8)
    ref = jax.tree.map(_to_numpy, tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert tio._encode_tree(tree) == jio._encode_tree(ref)
    # both packages read the other's raw payload back bitwise
    _assert_bitwise(tree, tio._decode_tree(jio._encode_tree(ref), tree))
    back = jio._decode_tree(tio._encode_tree(tree), ref, numpy=True)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("snap", SNAPS)
def test_whole_frame_byte_equal_under_zlib_crc32(lanes, snap):
    """The card host's codec (no zstandard, no xxhash): the port's frame
    equals the reference's frame of the same payload, byte for byte."""
    j, t = lanes
    meta = b"opaque bookkeeping"
    port = tio.dumps_framed(t[snap], meta=meta, codec=tio.CODEC_ZLIB, hash_id=tio.HASH_CRC32)
    ref_tree = _port_values_in_reference_tree(j[snap], t[snap])
    ref = jio.frame(zlib.compress(jio._encode_tree(ref_tree), 3), meta=meta, codec=jio.CODEC_ZLIB,
                    hash_id=jio.HASH_CRC32)
    assert port == ref
    assert tio.parse_frame_header(port) == jio.parse_frame_header(ref)


@pytest.mark.parametrize("codec", [None, tio.CODEC_ZLIB])
@pytest.mark.parametrize("snap", SNAPS)
def test_blobs_cross_read_both_ways(lanes, snap, codec):
    """A blob of the JAX package's ``dumps_framed`` read by the port's
    ``loads_framed`` (template: the port's lane), and the reverse
    (template: the reference's lane), bitwise, bf16 included."""
    j, t = lanes
    from_ref = tio.loads_framed(jio.dumps_framed(j[snap], codec=codec), t[snap])
    for (path, got), ref in zip(tio.tree_flatten_with_path(from_ref), jax.tree.leaves(j[snap])):
        assert tio.dtype_name(got.dtype) == str(ref.dtype) and tuple(got.shape) == ref.shape, path
        assert tio.leaf_bytes(got) == ref.tobytes(), path
    from_port = jio.loads_framed(tio.dumps_framed(t[snap], codec=codec), j[snap], numpy=True)
    for (path, ref), got in zip(tio.tree_flatten_with_path(t[snap]), jax.tree.leaves(from_port)):
        assert str(got.dtype) == tio.dtype_name(ref.dtype) and got.shape == tuple(ref.shape), path
        assert got.tobytes() == tio.leaf_bytes(ref), path
