"""Checkpointing: a msgpack + compressed tree codec over torch tensors.

Port of the JAX package's ``repro.checkpoint.io``, byte for byte in what it
writes. Each leaf is stored as (path, dtype name, shape, raw bytes) in a
msgpack array of maps; the path is the JAX key string of the leaf
(``['caches'].groups[0].k``), computed here over the port's own trees:
dicts (keys sorted, as JAX flattens them), lists and tuples, and
dataclasses (fields in order, as registered JAX dataclasses flatten). So a
payload written by either package is read by the other's
:func:`loads_framed`, given a template of the tree.

The port needs neither ``msgpack`` nor ``ml_dtypes``: it packs exactly the
payload it writes (an array of maps of str, bin and lists of non-negative
ints) itself, with the bytes ``msgpack.packb(payload, use_bin_type=True)``
gives, and reads leaves back through torch (``torch.frombuffer`` with the
dtype the name maps to), so bf16 leaves need no numpy dtype.

Three layers:

* :func:`dumps` / :func:`loads` — in-memory codec (bytes <-> tree),
  zstd-compressed (needs the optional ``zstandard``).
* :func:`dumps_framed` / :func:`loads_framed` — the FRAMED cold-blob format:
  a fixed header (magic ``WCSB``, version, codec, hash id) with a digest of
  the compressed payload and an optional metadata section with its own
  crc32. Readers verify before decoding, so a torn write, a truncated file
  or a flipped bit surfaces as :class:`CorruptBlobError`. The codec is zstd
  with xxh64 where those packages are installed, and stdlib zlib with crc32
  otherwise.
* :func:`save` / :func:`load` — file wrappers over the zstd codec (atomic
  rename on save).

Decoded leaves are CPU tensors. A template's leaves may be tensors, numpy
arrays or :class:`LeafSpec` (shape, dtype name) records: the cold tier keeps
only such a skeleton in memory.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

try:
    import zstandard
except ImportError:  # optional: only the zstd entry points need it
    zstandard = None

try:
    import xxhash
except ImportError:  # optional: frames fall back to crc32
    xxhash = None


class CorruptBlobError(ValueError):
    """A framed blob failed integrity verification (bad magic or version,
    truncation, length mismatch, or checksum mismatch). The payload must not
    be trusted; the cold tier quarantines the file instead of raising a
    decoder error mid-wake."""


class LeafSpec(NamedTuple):
    """Shape and dtype name of one leaf: what a skeleton holds in place of
    the tensor."""

    shape: tuple
    dtype: str


# dtype names as numpy (and ml_dtypes, for bf16) spell them in the payload
_DTYPES = {name: getattr(torch, name) for name in (
    "bfloat16", "float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "bool",
)}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _require_zstd():
    if zstandard is None:
        raise ModuleNotFoundError("zstandard is required for checkpoint save/load (pip install zstandard)")


# ---------------------------------------------------------------------------
# trees: leaves with their JAX key strings
# ---------------------------------------------------------------------------
def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, LeafSpec))


def tree_flatten_with_path(tree, prefix: str = "") -> list:
    """[(key string, leaf)] in JAX's flattening order. ``None`` holds no
    leaf, as in JAX."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_flatten_with_path(v, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree):
        return [kv for f in dataclasses.fields(tree)
                for kv in tree_flatten_with_path(getattr(tree, f.name), f"{prefix}.{f.name}")]
    raise TypeError(f"unsupported tree node {type(tree).__name__} at {prefix or 'the root'}")


def tree_map_with_path(fn, tree, prefix: str = ""):
    """The tree rebuilt with every leaf replaced by ``fn(key string, leaf)``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}[{k!r}]") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map_with_path(fn, getattr(tree, f.name), f"{prefix}.{f.name}")
                             for f in dataclasses.fields(tree)})
    raise TypeError(f"unsupported tree node {type(tree).__name__} at {prefix or 'the root'}")


def tree_map(fn, tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor (numpy leaves, scalars included, become CPU
    tensors of their dtype; tensors are returned as they are)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.array(leaf, copy=True)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array: numpy itself has no bf16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def spec_of(leaf) -> LeafSpec:
    if isinstance(leaf, LeafSpec):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return LeafSpec(tuple(leaf.shape), dtype_name(leaf.dtype))
    a = np.asarray(leaf)
    return LeafSpec(tuple(a.shape), str(a.dtype))


def leaf_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a tensor in row-major order."""
    t = t.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


def leaf_from_bytes(data, dtype: str, shape) -> torch.Tensor:
    """A new CPU tensor from raw bytes (the inverse of :func:`leaf_bytes`)."""
    dt = _DTYPES.get(dtype)
    if dt is None:
        raise ValueError(f"unsupported leaf dtype {dtype!r}")
    shape = tuple(int(s) for s in shape)
    if len(data) == 0:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(data), dtype=dt).reshape(shape)


# ---------------------------------------------------------------------------
# msgpack, for the payload's own types only
# ---------------------------------------------------------------------------
def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool):
        raise TypeError("the payload holds no bool")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError("the payload holds no negative int")
        if obj <= 0x7F:
            out.append(obj)
        elif obj <= 0xFF:
            out += struct.pack(">BB", 0xCC, obj)
        elif obj <= 0xFFFF:
            out += struct.pack(">BH", 0xCD, obj)
        elif obj <= 0xFFFFFFFF:
            out += struct.pack(">BI", 0xCE, obj)
        else:
            out += struct.pack(">BQ", 0xCF, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += struct.pack(">BB", 0xD9, n)
        elif n <= 0xFFFF:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        if n <= 0xFF:
            out += struct.pack(">BB", 0xC4, n)
        elif n <= 0xFFFF:
            out += struct.pack(">BH", 0xC5, n)
        else:
            out += struct.pack(">BI", 0xC6, n)
        out += obj
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n <= 15:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out += struct.pack(">BH", 0xDC, n)
        else:
            out += struct.pack(">BI", 0xDD, n)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n <= 15:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out += struct.pack(">BH", 0xDE, n)
        else:
            out += struct.pack(">BI", 0xDF, n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the payload holds no {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the payload's types."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}  # tag -> width of the unsigned ints
_LEN = {  # tag -> (kind, length format) of the sized types
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def unpackb(data: bytes):
    """Decode one msgpack object of the payload's types (str as str, bin as
    bytes, non-negative ints, arrays, maps); raises ValueError on anything
    else, on truncated and on trailing data."""
    buf = memoryview(data)
    pos = 0

    def take(n: int):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError("truncated msgpack data")
        out = buf[pos:pos + n]
        pos += n
        return out

    def obj():
        tag = take(1)[0]
        if tag <= 0x7F:
            return tag
        if 0x80 <= tag <= 0x8F:
            return sized("map", tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return sized("array", tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return sized("str", tag & 0x1F)
        if tag in _UINT:
            fmt = _UINT[tag]
            return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]
        if tag in _LEN:
            kind, fmt = _LEN[tag]
            return sized(kind, struct.unpack(fmt, take(struct.calcsize(fmt)))[0])
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")

    def sized(kind: str, n: int):
        if kind == "bin":
            return bytes(take(n))
        if kind == "str":
            return str(take(n), "utf-8")
        if kind == "array":
            return [obj() for _ in range(n)]
        return {obj(): obj() for _ in range(n)}

    out = obj()
    if pos != len(buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# the payload
# ---------------------------------------------------------------------------
def _encode_tree(tree) -> bytes:
    payload = []
    for path, leaf in tree_flatten_with_path(tree):
        t = as_tensor(leaf)
        payload.append({
            "path": path,
            "dtype": dtype_name(t.dtype),
            "shape": list(t.shape),
            "data": leaf_bytes(t),
        })
    return packb(payload)


def _decode_tree(raw: bytes, like):
    """Rebuild the tree of ``like`` (structure only: its leaves may be
    tensors, numpy arrays or :class:`LeafSpec`) from an encoded payload, as
    CPU tensors."""
    by_path = {p["path"]: p for p in unpackb(raw)}

    def leaf(path, _):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        rec = by_path[path]
        return leaf_from_bytes(rec["data"], rec["dtype"], rec["shape"])

    return tree_map_with_path(leaf, like)


def dumps(tree, *, level: int = 3) -> bytes:
    """Serialize a tree to a compressed blob (msgpack + zstd)."""
    _require_zstd()
    return zstandard.ZstdCompressor(level=level).compress(_encode_tree(tree))


def loads(data: bytes, like):
    """Restore a tree from a :func:`dumps` blob into the structure of
    ``like``. Raises KeyError on missing leaves."""
    _require_zstd()
    return _decode_tree(zstandard.ZstdDecompressor().decompress(data), like)


# ---------------------------------------------------------------------------
# Framed cold-blob format: integrity-checked, versioned container.
#
#   magic(4) version(u8) codec(u8) hash_id(u8) reserved(u8)
#   meta_len(u32) payload_len(u64) meta_crc32(u32) payload_digest(u64)
#   [meta bytes] [payload bytes]
#
# The digest covers the COMPRESSED payload, so verification never feeds
# untrusted bytes to the decompressor. ``meta`` is an opaque caller section
# checked by its own crc32: recovery reads header and meta without touching
# the payload of every blob.
# ---------------------------------------------------------------------------
FRAME_MAGIC = b"WCSB"
FRAME_VERSION = 1
_FRAME_HDR = struct.Struct("<4sBBBBIQIQ")
FRAME_HEADER_BYTES = _FRAME_HDR.size

CODEC_ZLIB, CODEC_ZSTD = 0, 1
HASH_CRC32, HASH_XXH64 = 0, 1
_CODEC_NAMES = {CODEC_ZLIB: "zlib", CODEC_ZSTD: "zstd"}


def codec_name(codec: int) -> str:
    return _CODEC_NAMES[codec]


def default_codec() -> int:
    """zstd when the optional package is present, stdlib zlib otherwise."""
    return CODEC_ZSTD if zstandard is not None else CODEC_ZLIB


def _default_hash_id() -> int:
    return HASH_XXH64 if xxhash is not None else HASH_CRC32


def _digest(data: bytes, hash_id: int) -> int:
    if hash_id == HASH_XXH64:
        if xxhash is None:
            raise CorruptBlobError("blob digest uses xxh64 but xxhash is not installed: cannot verify integrity")
        return xxhash.xxh64(data).intdigest()
    if hash_id == HASH_CRC32:
        return zlib.crc32(data) & 0xFFFFFFFF
    raise CorruptBlobError(f"unknown blob hash id {hash_id}")


def _compress(raw: bytes, codec: int, level: int) -> bytes:
    if codec == CODEC_ZSTD:
        _require_zstd()
        return zstandard.ZstdCompressor(level=level).compress(raw)
    if codec == CODEC_ZLIB:
        return zlib.compress(raw, min(9, max(1, level)))
    raise ValueError(f"unknown blob codec {codec}")


def _decompress(payload: bytes, codec: int) -> bytes:
    if codec == CODEC_ZSTD:
        _require_zstd()
        return zstandard.ZstdDecompressor().decompress(payload)
    if codec == CODEC_ZLIB:
        return zlib.decompress(payload)
    raise CorruptBlobError(f"unknown blob codec {codec}")


def frame(payload: bytes, *, meta: bytes = b"", codec: int | None = None,
          hash_id: int | None = None) -> bytes:
    """Wrap the compressed ``payload`` (and an opaque ``meta`` section) in
    the checksummed frame header."""
    codec = default_codec() if codec is None else codec
    hash_id = _default_hash_id() if hash_id is None else hash_id
    hdr = _FRAME_HDR.pack(
        FRAME_MAGIC, FRAME_VERSION, codec, hash_id, 0,
        len(meta), len(payload), zlib.crc32(meta) & 0xFFFFFFFF,
        _digest(payload, hash_id),
    )
    return hdr + meta + payload


def parse_frame_header(data: bytes) -> dict:
    """Validate and unpack the fixed header (magic, version, lengths; no
    digest check, see :func:`unframe`). Raises :class:`CorruptBlobError`
    on anything that cannot be a well-formed current-version frame."""
    if len(data) < FRAME_HEADER_BYTES:
        raise CorruptBlobError(f"truncated blob: {len(data)} bytes < {FRAME_HEADER_BYTES}-byte header")
    magic, version, codec, hash_id, _, meta_len, payload_len, meta_crc, digest = _FRAME_HDR.unpack_from(data)
    if magic != FRAME_MAGIC:
        raise CorruptBlobError(f"bad blob magic {magic!r}")
    if version != FRAME_VERSION:
        raise CorruptBlobError(f"unsupported blob version {version}")
    if codec not in _CODEC_NAMES:
        raise CorruptBlobError(f"unknown blob codec {codec}")
    return {
        "codec": codec, "hash_id": hash_id, "meta_len": meta_len,
        "payload_len": payload_len, "meta_crc": meta_crc, "digest": digest,
    }


def unframe(data: bytes, *, verify: bool = True) -> tuple[bytes, bytes, int]:
    """Split a framed blob into ``(meta, payload, codec)``, verifying lengths
    and checksums. ``verify=False`` skips the payload digest but still
    validates the structure."""
    hdr = parse_frame_header(data)
    expected = FRAME_HEADER_BYTES + hdr["meta_len"] + hdr["payload_len"]
    if len(data) != expected:
        raise CorruptBlobError(f"truncated/oversized blob: {len(data)} bytes, header says {expected}")
    meta = data[FRAME_HEADER_BYTES:FRAME_HEADER_BYTES + hdr["meta_len"]]
    payload = data[FRAME_HEADER_BYTES + hdr["meta_len"]:]
    if (zlib.crc32(meta) & 0xFFFFFFFF) != hdr["meta_crc"]:
        raise CorruptBlobError("blob metadata checksum mismatch")
    if verify and _digest(payload, hdr["hash_id"]) != hdr["digest"]:
        raise CorruptBlobError("blob payload checksum mismatch")
    return meta, payload, hdr["codec"]


def read_frame_meta(path: str) -> bytes:
    """Read and verify ONLY the header and metadata section of a framed blob
    file (no payload read, no decompression). The file's size is checked
    against the header, so truncation is still caught. Used by
    ``SynapseStore.recover`` to rebuild the cold index after a crash."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        hdr = parse_frame_header(f.read(FRAME_HEADER_BYTES))
        expected = FRAME_HEADER_BYTES + hdr["meta_len"] + hdr["payload_len"]
        if size != expected:
            raise CorruptBlobError(f"truncated/oversized blob file: {size} bytes, header says {expected}")
        meta = f.read(hdr["meta_len"])
    if len(meta) != hdr["meta_len"] or (zlib.crc32(meta) & 0xFFFFFFFF) != hdr["meta_crc"]:
        raise CorruptBlobError("blob metadata checksum mismatch")
    return meta


def dumps_framed(tree, *, level: int = 3, meta: bytes = b"", codec: int | None = None,
                 hash_id: int | None = None) -> bytes:
    """Serialize a tree into the framed, integrity-checked cold format."""
    codec = default_codec() if codec is None else codec
    return frame(_compress(_encode_tree(tree), codec, level), meta=meta, codec=codec, hash_id=hash_id)


def loads_framed(data: bytes, like, *, verify: bool = True):
    """Restore a tree from a :func:`dumps_framed` blob, verifying the frame
    first. Raises :class:`CorruptBlobError` on any integrity failure and
    KeyError on missing leaves (like :func:`loads`)."""
    _, payload, codec = unframe(data, verify=verify)
    try:
        raw = _decompress(payload, codec)
    except CorruptBlobError:
        raise
    except Exception as e:  # zlib.error / ZstdError: corrupt despite the digest
        raise CorruptBlobError(f"blob payload undecompressable: {e}") from e
    try:
        return _decode_tree(raw, like)
    except KeyError:
        raise  # a missing leaf is a schema error, not bad bytes
    except Exception as e:
        # with verify=False a flipped bit can land here instead of upstream
        raise CorruptBlobError(f"blob payload undecodable: {e}") from e


def save(path: str, tree, *, level: int = 3) -> None:
    comp = dumps(tree, level=level)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)


def load(path: str, like):
    """Restore into the structure of ``like``."""
    _require_zstd()
    with open(path, "rb") as f:
        data = f.read()
    return loads(data, like)
