"""Byte-level tokenizer with a few control specials.

Deterministic, dependency-free: token ids 0..255 are raw bytes; specials
follow. Enough for the engine demos, router-trigger round-trips, and the
synthetic training pipeline. Configs with larger vocabs simply leave the
tail unused (ids < vocab_size always holds for vocab >= 272).

:class:`Utf8StreamDecoder` is the streaming counterpart of
:meth:`ByteTokenizer.decode`: token ids arrive in arbitrary
chunks — one per step on the serving path, one window per drain on the
engine path — and a multi-byte UTF-8 codepoint may split across any chunk
boundary. Decoding each chunk independently with ``errors="replace"``
turns every split codepoint into U+FFFD garbage; the stream decoder
buffers the incomplete trailing sequence instead, so the concatenation of
its outputs (plus a final :meth:`~Utf8StreamDecoder.flush`) is bitwise
identical to ``decode(all_ids)`` no matter where the chunks were cut.
"""
from __future__ import annotations

import codecs

import numpy as np

SPECIALS = ["<pad>", "<bos>", "<eos>", "<task>", "<answer>"]


class ByteTokenizer:
    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 256 + len(SPECIALS), vocab_size
        self.vocab_size = vocab_size
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258

    def encode(self, text: str, *, bos: bool = False, eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        out = bytearray()
        for i in np.asarray(ids).tolist():
            if 0 <= i < 256:
                out.append(i)
        return out.decode("utf-8", errors="replace")

    def stream_decoder(self) -> "Utf8StreamDecoder":
        return Utf8StreamDecoder(self)


class Utf8StreamDecoder:
    """Stateful incremental decoder over byte-token ids.

    Invariant (asserted by the JAX package's UTF-8 stream tests over every split
    point): for ANY partition of ``ids`` into chunks,

        "".join(dec.feed(c) for c in chunks) + dec.flush()
            == tokenizer.decode(ids)

    bitwise — including invalid byte sequences, which replace with U+FFFD
    under the exact same maximal-subpart rules as the one-shot decode.
    Backed by CPython's incremental UTF-8 codec (the machinery under
    TextIOWrapper), whose only state is the buffered incomplete trailing
    sequence (<= 3 bytes): :attr:`pending` exports it so a hibernated
    agent's half-received codepoint survives a park/wake or a process
    crash and the stream resumes bitwise.
    """

    def __init__(self, tokenizer: ByteTokenizer):
        self.tok = tokenizer
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def feed(self, ids) -> str:
        """Decode a chunk of token ids; returns only the complete text
        (an incomplete trailing codepoint stays buffered for the next
        chunk). Non-byte ids (specials, ring padding) are skipped exactly
        as :meth:`ByteTokenizer.decode` skips them."""
        raw = bytes(i for i in np.asarray(ids, dtype=np.int64).tolist() if 0 <= i < 256)
        return self._dec.decode(raw, False)

    def flush(self) -> str:
        """End of stream: replace any buffered incomplete sequence (this is
        what makes the final text equal the one-shot decode bitwise)."""
        return self._dec.decode(b"", True)

    @property
    def pending(self) -> bytes:
        """The buffered incomplete trailing sequence (b"" when aligned)."""
        return self._dec.getstate()[0]

    def tail(self) -> str:
        """What :meth:`flush` WOULD emit, without consuming the state —
        lets callers peek at the end-of-stream text mid-flight."""
        return self.pending.decode("utf-8", errors="replace")

    def restore(self, pending: bytes) -> None:
        """Rehydrate after hibernate/crash-recovery: resume mid-codepoint."""
        self._dec.reset()
        self._dec.setstate((bytes(pending), 0))
