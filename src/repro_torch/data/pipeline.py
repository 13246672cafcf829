"""Deterministic synthetic data pipeline.

The port's own copy of the JAX package's ``repro.data.pipeline`` (the port
imports nothing of that package): the batches are made in numpy by the
same code, so both packages' batches are equal bit for bit for the same
config and seed; :func:`batch_to` puts one on a device.

Three sources, mixed per document:
  * "copy":   A<sep>A — forces content-addressable attention (the synapse
              quality benchmark uses this: landmark selection must keep the
              payload tokens).
  * "arith":  byte-rendered modular additions "12+34=46;" — learnable
              structure for the ~100M end-to-end training example.
  * "lm":     Zipf-distributed byte n-gram soup — generic LM load.

Also provides embedding batches for the stubbed-frontend archs (audio/vlm).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    batch_size: int = 8
    vocab_size: int = 512
    mix: tuple[float, float, float] = (0.3, 0.4, 0.3)  # copy, arith, lm
    seed: int = 0


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 256)
        ranks = np.arange(1, v + 1)
        self.zipf = (1.0 / ranks) / np.sum(1.0 / ranks)

    def _doc_copy(self, n: int) -> np.ndarray:
        half = max(2, n // 2 - 1)
        payload = self.rng.integers(ord("a"), ord("z") + 1, size=half)
        sep = np.asarray([ord("|")])
        doc = np.concatenate([payload, sep, payload])
        return doc[:n]

    def _doc_arith(self, n: int) -> np.ndarray:
        out = []
        while sum(len(o) for o in out) < n:
            a, b = self.rng.integers(0, 100, size=2)
            out.append(np.frombuffer(f"{a}+{b}={(a + b) % 100};".encode(), dtype=np.uint8).astype(np.int64))
        return np.concatenate(out)[:n]

    def _doc_lm(self, n: int) -> np.ndarray:
        v = len(self.zipf)
        return self.rng.choice(v, size=n, p=self.zipf)

    def batch(self) -> dict:
        """-> {"tokens": [B,S] int32, "labels": [B,S] int32}."""
        B, S = self.cfg.batch_size, self.cfg.seq_len
        toks = np.zeros((B, S + 1), np.int32)
        kinds = self.rng.choice(3, size=B, p=np.asarray(self.cfg.mix))
        for i, kind in enumerate(kinds):
            doc = (self._doc_copy, self._doc_arith, self._doc_lm)[kind](S + 1)
            toks[i, : len(doc)] = doc
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def embed_batch(self, d_model: int, with_positions_3d: bool = False) -> dict:
        """Stub-frontend batch: frame/patch embeddings + byte-bucket labels."""
        B, S = self.cfg.batch_size, self.cfg.seq_len
        emb = self.rng.standard_normal((B, S, d_model), dtype=np.float32)
        labels = self.rng.integers(0, self.cfg.vocab_size, size=(B, S)).astype(np.int32)
        out = {"embeds": emb, "labels": labels}
        if with_positions_3d:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None, :], (B, 3, S)).copy()
            out["positions"] = pos
        return out


def make_batch(cfg: ModelConfig, data_cfg: DataConfig) -> dict:
    corpus = SyntheticCorpus(
        DataConfig(
            seq_len=data_cfg.seq_len,
            batch_size=data_cfg.batch_size,
            vocab_size=cfg.vocab_size,
            mix=data_cfg.mix,
            seed=data_cfg.seed,
        )
    )
    if cfg.embed_inputs:
        return corpus.batch()
    return corpus.embed_batch(cfg.d_model, with_positions_3d=cfg.rope_kind == "mrope")


def batch_to(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (int32 and f32 as made)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
