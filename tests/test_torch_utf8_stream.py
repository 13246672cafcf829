"""The port's streaming UTF-8 decoder (``repro_torch.data.tokenizer``)
against the JAX package's: the seven ``test_decoder_*`` cases of
``tests/test_utf8_stream.py`` (its lines 58-136), the raw-byte case
parametrised as there. Each case holds the reference test's property and,
on the same id streams and chunkings, the reference's
``Utf8StreamDecoder`` output byte for byte (every ``feed``, ``flush``,
``tail`` and ``pending``).

The reference module's server and engine cases (final text equal to the
one-shot decode, hibernate keeping the pending tail) are covered by
``tests/test_torch_serving.py`` (text == decode over both backends) and
``tests/test_torch_memory_tiers.py`` (the pending tail through hibernate
and wake). Exact comparisons only: no tolerance.
"""
import numpy as np
import pytest
from conftest import hypothesis_tools

from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro_torch.data.tokenizer import ByteTokenizer

MULTI = "héllo ∑ x² — 日本語 🚀 done"

given, settings, st = hypothesis_tools()


class _Both:
    """The port's and the reference's decoders fed the same chunks; every
    output of the port's must equal the reference's."""

    def __init__(self):
        self.dec, self.ref = ByteTokenizer().stream_decoder(), JaxTokenizer().stream_decoder()

    def feed(self, ids):
        out = self.dec.feed(ids)
        assert out == self.ref.feed(ids)
        return out

    def flush(self):
        out = self.dec.flush()
        assert out == self.ref.flush()
        return out

    def tail(self):
        out = self.dec.tail()
        assert out == self.ref.tail()
        return out

    @property
    def pending(self):
        assert self.dec.pending == self.ref.pending
        return self.dec.pending

    def restore(self, pending):
        self.dec.restore(pending)
        self.ref.restore(pending)


def test_decoder_every_split_point_bitwise():
    tok = ByteTokenizer()
    ids = tok.encode(MULTI)
    want = tok.decode(ids)
    assert want == JaxTokenizer().decode(ids)
    for cut in range(len(ids) + 1):
        dec = _Both()
        got = dec.feed(ids[:cut]) + dec.feed(ids[cut:]) + dec.flush()
        assert got == want, f"split at {cut}"


def test_decoder_one_id_at_a_time():
    tok = ByteTokenizer()
    ids = tok.encode(MULTI, bos=True, eos=True)
    assert ids == JaxTokenizer().encode(MULTI, bos=True, eos=True)
    dec = _Both()
    got = "".join(dec.feed([i]) for i in ids) + dec.flush()
    assert got == tok.decode(ids)
    # a per-id decode really does differ on this input
    buggy = "".join(tok.decode([i]) for i in ids)
    assert buggy != got and "�" in buggy


@pytest.mark.parametrize("raw", [
    b"\xe2\x82",                      # truncated 3-byte sequence at the end
    b"\xe2\x28\xa1",                  # invalid continuation byte
    b"ok \xf0\x9f\x9a\x80 \xff end",  # a lone invalid byte beside a valid emoji
    bytes(range(120, 256)),           # dense high-byte garbage
])
def test_decoder_invalid_bytes_match_oneshot(raw):
    tok = ByteTokenizer()
    ids = list(raw)
    want = tok.decode(ids)
    assert want == JaxTokenizer().decode(ids)
    for size in (1, 2, 3, 5):
        dec = _Both()
        got = "".join(dec.feed(ids[i:i + size]) for i in range(0, len(ids), size)) + dec.flush()
        assert got == want, f"chunk size {size}"


def test_decoder_skips_specials_mid_codepoint():
    tok = ByteTokenizer()
    rocket = list("🚀".encode("utf-8"))
    ids = rocket[:2] + [tok.eos_id, tok.pad_id] + rocket[2:]
    dec = _Both()
    got = dec.feed(ids[:3]) + dec.feed(ids[3:]) + dec.flush()
    assert got == tok.decode(ids) == "🚀"


def test_decoder_pending_export_restore_bitwise():
    tok = ByteTokenizer()
    ids = tok.encode(MULTI)
    for cut in range(len(ids) + 1):
        a = _Both()
        head = a.feed(ids[:cut])
        moved = _Both()
        moved.restore(a.pending)  # the hibernate / crash-recovery path
        got = head + moved.feed(ids[cut:]) + moved.flush()
        assert got == tok.decode(ids), f"restore at {cut}"


def test_decoder_tail_peeks_without_consuming():
    rocket = list("🚀".encode("utf-8"))
    dec = _Both()
    dec.feed(rocket[:2])  # half a codepoint buffered
    assert dec.tail() == "�" == dec.tail()  # an idempotent peek
    assert dec.pending == bytes(rocket[:2])
    assert dec.feed(rocket[2:]) + dec.flush() == "🚀"


@given(
    data=st.lists(st.integers(min_value=0, max_value=300), max_size=60),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
@settings(max_examples=80, deadline=None)
def test_decoder_random_chunking_property(data, seed):
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    dec, out, i = _Both(), [], 0
    while i < len(data):
        step = int(rng.integers(1, 5))
        out.append(dec.feed(data[i:i + step]))
        i += step
    out.append(dec.flush())
    assert "".join(out) == tok.decode(data) == JaxTokenizer().decode(data)
