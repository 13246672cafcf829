"""Carry weights and decode state between the JAX package and the port,
through numpy only (this module imports neither ``jax`` nor ``repro``).

* :func:`params_from_jax` turns the JAX ``init_params`` pytree — given as
  numpy arrays: ``embed``, ``groups[g]`` stacked on a leading layer axis,
  ``final_norm``, and ``head`` unless embeddings are tied — into the
  port's parameter dict. The layouts are the same, so it is leaf by leaf.
* :func:`caches_from_numpy` / :func:`caches_to_numpy` convert ``FullCache``,
  ``SynapseCache`` and ``ModelCaches`` both ways. The numpy side is any
  object with the reference's field names (a JAX cache dataclass whose
  leaves went through ``np.asarray``) or a dict of them, so a port step can
  start from a reference state.

Every conversion is bitwise: bf16 leaves go through f32, which holds every
bf16 value exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def to_torch(a, device=None) -> torch.Tensor:
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
    ``device``. Checks the tree's keys against what ``cfg`` needs."""
    want = {"embed", "groups", "final_norm"} | (set() if cfg.tie_embeddings else {"head"})
    if set(np_tree) != want:
        raise ValueError(f"params tree has keys {sorted(np_tree)}, config {cfg.name} needs {sorted(want)}")
    if len(np_tree["groups"]) != len(cfg.layer_groups()):
        raise ValueError("params tree has a different number of layer groups than the config")
    return model_lib.tree_map(lambda a: to_torch(a, device), dict(np_tree))


def params_to_numpy(params):
    return model_lib.tree_map(to_numpy, params)


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    return {f: getattr(obj, f) for f in obj.__dataclass_fields__}


def cache_from_numpy(obj, device=None):
    """One FullCache / SynapseCache from numpy fields (object or dict)."""
    fields = _fields(obj)
    cls = cache_lib.SynapseCache if "lm_k" in fields else cache_lib.FullCache
    names = [f.name for f in dataclasses.fields(cls)]
    return cls(**{n: to_torch(fields[n], device) for n in names})


def cache_to_numpy(cache) -> dict:
    return {f.name: to_numpy(getattr(cache, f.name)) for f in dataclasses.fields(cache)}


def caches_from_numpy(obj, device=None) -> model_lib.ModelCaches:
    """ModelCaches from an object or dict with ``groups`` (and ``shared``,
    which must be None in this slice)."""
    fields = _fields(obj)
    if fields.get("shared") is not None:
        raise NotImplementedError("shared-attention caches are ROADMAP queue-1 item 13")
    return model_lib.ModelCaches(groups=tuple(cache_from_numpy(g, device) for g in fields["groups"]))


def caches_to_numpy(caches: model_lib.ModelCaches) -> dict:
    return {"groups": [cache_to_numpy(g) for g in caches.groups], "shared": None}
