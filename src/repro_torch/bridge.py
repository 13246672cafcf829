"""Carry weights and decode state between the JAX package and the port,
through numpy only (this module imports neither ``jax`` nor ``repro``).

* :func:`params_from_jax` turns the JAX ``init_params`` pytree — given as
  numpy arrays: ``embed`` (not for the encoder-only model), ``groups[g]``
  stacked on a leading layer axis (attention with GQA or MLA, dense, MoE
  with its experts and shared experts, Mamba2, RWKV6), ``shared_attn``
  (the hybrid's shared block with its stacked LoRA), ``final_norm``, and
  ``head`` unless embeddings are tied — into the port's parameter dict.
  The layouts are the same, so it is leaf by leaf.
* :func:`caches_from_numpy` / :func:`caches_to_numpy` convert every cache
  kind (``FullCache``, ``SynapseCache``, ``MLACache``, ``Mamba2State``,
  ``RWKV6State``) and ``ModelCaches`` — its groups and its ``shared``
  caches — both ways. The numpy side is any object with the reference's
  field names (a JAX cache dataclass whose leaves went through
  ``np.asarray``) or a dict of them, so a port step can start from a
  reference state.

Every conversion is bitwise: bf16 leaves go through f32, which holds every
bf16 value exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def to_torch(a, device) -> torch.Tensor:
    """numpy -> tensor on ``device`` (named by the caller; bf16 through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bf16 comes back as f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    """The JAX params pytree (numpy leaves) -> the port's params on
    ``device`` (None: the card, raising where there is none). Checks the
    tree's keys against what ``cfg`` needs."""
    want = {"groups", "final_norm"}
    want |= {"embed"} if cfg.embed_inputs or not cfg.is_encoder_only else set()
    want |= set() if cfg.tie_embeddings else {"head"}
    want |= {"shared_attn"} if cfg.shared_attn_every > 0 else set()
    if set(np_tree) != want:
        raise ValueError(f"params tree has keys {sorted(np_tree)}, config {cfg.name} needs {sorted(want)}")
    if len(np_tree["groups"]) != len(cfg.layer_groups()):
        raise ValueError("params tree has a different number of layer groups than the config")
    dev = resolve_device(device)
    return model_lib.tree_map(lambda a: to_torch(a, dev), dict(np_tree))


def params_to_numpy(params):
    return model_lib.tree_map(to_numpy, params)


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    return {f: getattr(obj, f) for f in obj.__dataclass_fields__}


# the field that tells each cache kind apart, in the reference's layout
_KINDS = (("lm_k", cache_lib.SynapseCache), ("ckv", cache_lib.MLACache), ("ssm", cache_lib.Mamba2State),
          ("wkv", cache_lib.RWKV6State), ("k", cache_lib.FullCache))


def cache_from_numpy(obj, device=None):
    """One cache of any kind from numpy fields (object or dict), on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    fields = _fields(obj)
    cls = next(c for key, c in _KINDS if key in fields)
    names = [f.name for f in dataclasses.fields(cls)]
    return cls(**{n: to_torch(fields[n], dev) for n in names})


def cache_to_numpy(cache) -> dict:
    return {f.name: to_numpy(getattr(cache, f.name)) for f in dataclasses.fields(cache)}


def caches_from_numpy(obj, device=None) -> model_lib.ModelCaches:
    """ModelCaches from an object or dict with ``groups`` and ``shared``
    (None outside the hybrid), on ``device`` (None: the card)."""
    dev = resolve_device(device)
    fields = _fields(obj)
    shared = fields.get("shared")
    return model_lib.ModelCaches(groups=tuple(cache_from_numpy(g, dev) for g in fields["groups"]),
                                 shared=None if shared is None else cache_from_numpy(shared, dev))


def caches_to_numpy(caches: model_lib.ModelCaches) -> dict:
    return {"groups": [cache_to_numpy(g) for g in caches.groups],
            "shared": None if caches.shared is None else cache_to_numpy(caches.shared)}
