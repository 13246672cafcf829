"""Dense decoder: parameters, caches, prefill and one-token decode.

Port of the JAX package's ``repro.models.model`` for dense GQA attention
groups. Parameters are a nested dict with the reference's layout — ``embed``
[V, d], ``groups[g]`` with every leaf stacked on a leading layer axis,
``final_norm``, and ``head`` unless embeddings are tied — so
:mod:`repro_torch.bridge` carries JAX weights over leaf by leaf. The layer
stack is a Python loop over the stacked leaves. Decode updates the caches
IN PLACE (the reference donates them).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import synapse as synapse_lib
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention, cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, embed_init, rms_norm, swiglu, swiglu_init


@dataclass(frozen=True)
class CacheSpec:
    kind: str = "full"            # full | synapse
    capacity: int = 4096          # full-cache slots (>= prompt + decode budget)
    n_landmarks: int = 64         # synapse: K
    window: int = 128             # synapse: W
    n_inject: int = 8             # synapse: J (referential-injection slots)
    policy: synapse_lib.SynapsePolicy = field(default_factory=synapse_lib.SynapsePolicy)


@dataclass
class ModelCaches:
    """Decode state for the whole stack: one stacked [L, B, ...] cache per
    layer group. ``shared`` (hybrid shared attention) is always None in this
    slice; the field keeps the reference's layout."""

    groups: tuple
    shared: object = None


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _attn_init(gen, cfg: ModelConfig, dtype, device, lead):
    h, hkv, d, dm = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    p = {
        "wq": dense_init(gen, dm, h * d, dtype, device, lead=lead),
        "wk": dense_init(gen, dm, hkv * d, dtype, device, lead=lead),
        "wv": dense_init(gen, dm, hkv * d, dtype, device, lead=lead),
        "wo": dense_init(gen, h * d, dm, dtype, device, lead=lead),
    }
    z = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = z(h * d), z(hkv * d), z(hkv * d)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = z(d) + 1, z(d) + 1
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless ``device="cpu"``). The layout matches the reference's
    ``init_params``; the values do not (a different generator)."""
    attention.check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = torch_dtype(cfg.param_dtype)
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)}
    groups = []
    for grp in cfg.layer_groups():
        L = (grp.count,)
        groups.append({
            "ln1": ones(grp.count, cfg.d_model),
            "ln2": ones(grp.count, cfg.d_model),
            "attn": _attn_init(gen, cfg, dtype, device, L),
            "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, device, lead=L),
        })
    params["groups"] = groups
    params["final_norm"] = ones(cfg.d_model)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device)
    return params


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def cast_params(params, cfg: ModelConfig):
    """Float leaves to the compute dtype (a new tree; leaves already in that
    dtype are shared, not copied)."""
    compute = torch_dtype(cfg.compute_dtype)
    return tree_map(lambda a: a.to(compute) if a.is_floating_point() else a, params)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _radd(x, y):
    """Residual add keeping the stream dtype."""
    return x + y.to(x.dtype)


def _head(params, cfg: ModelConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ head.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, spec: CacheSpec, *, device) -> ModelCaches:
    attention.check_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    out = []
    for grp in cfg.layer_groups():
        L = (grp.count,)
        if spec.kind == "synapse":
            c = cache_lib.init_synapse_cache(
                cfg, batch, spec.n_landmarks, spec.window, spec.n_inject, dtype, device=device, lead=L)
        else:
            c = cache_lib.init_full_cache(cfg, batch, spec.capacity, dtype, device=device, lead=L)
        out.append(c)
    return ModelCaches(groups=tuple(out))


def layer_cache(c, i: int):
    """Views of layer ``i`` of a stacked cache: writes reach the stack."""
    return cache_lib.map_cache(lambda a: a[i], c)


def lane_caches(caches: ModelCaches, lane: int) -> ModelCaches:
    """One lane of the stacked caches, keeping the lane axis (axis 1; axis
    0 is the stacked layer dim), as views."""
    return ModelCaches(groups=tuple(cache_lib.map_cache(lambda a: a[:, lane:lane + 1], c) for c in caches.groups))


def write_lane(caches: ModelCaches, part: ModelCaches, lane: int) -> None:
    """In place: ``lane`` of the stacked caches takes the values of the
    one-lane caches ``part``."""
    for dst, src in zip(caches.groups, part.groups):
        for a, b in zip(cache_lib.tensors(dst), cache_lib.tensors(src)):
            a[:, lane:lane + 1].copy_(b)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))


def _last_query(block_params, cfg: ModelConfig, x_in, positions):
    """The last position's rotated query [B,H,D] (one token's work)."""
    h = rms_norm(x_in[:, -1:, :], block_params["ln1"], cfg.norm_eps)
    q, _, _ = attention._project_qkv(block_params["attn"], cfg, h)
    q = attention._rotate(cfg, q, positions[:, -1:])
    return q[:, 0]


def _attn_block_fwd(p, cfg: ModelConfig, x, positions, chunk):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, kv = attention.attention_forward(p["attn"], cfg, h, positions, chunk=chunk)
    x = _radd(x, y)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return _radd(x, swiglu(p["mlp"], h)), kv


def prefill(params, cfg: ModelConfig, inputs: dict, caches: ModelCaches, *, spec: CacheSpec, chunk: int = 1024):
    """Run the prompt through the stack, filling ``caches`` in place from
    slot 0. For spec.kind == "synapse" each layer's prompt KV is compressed
    at once by hybrid landmark selection, with the last token's query as the
    paper's Q_t. Returns (logits_last [B,V] f32, hidden_last [B,d], caches).
    """
    tokens = inputs["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    if "positions" in inputs:
        positions = inputs["positions"]
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    for g, grp in enumerate(cfg.layer_groups()):
        pg, cg = params["groups"][g], caches.groups[g]
        for i in range(grp.count):
            p_layer = _layer(pg, i)
            carry = x
            x, (k_rot, v) = _attn_block_fwd(p_layer, cfg, carry, positions, chunk)
            q_last = _last_query(p_layer, cfg, carry, positions)
            cache = layer_cache(cg, i)
            if spec.kind == "synapse":
                full = cache_lib.FullCache(
                    k_rot.to(cache.lm_k.dtype), v.to(cache.lm_v.dtype), positions.to(torch.int32),
                    torch.zeros(positions.shape, dtype=torch.float32, device=x.device), lengths,
                )
                comp = synapse_lib.compress(
                    cfg, full, q_last, cache.n_landmarks, cache.window, cache.n_inject, spec.policy)
                cache_lib.copy_into(cache, comp)
            else:
                dens = synapse_lib.attention_density(
                    q_last, k_rot.to(cache.k.dtype), torch.ones(k_rot.shape[:2], dtype=torch.bool, device=x.device))
                cache.k[:, :S] = k_rot.to(cache.k.dtype)
                cache.v[:, :S] = v.to(cache.v.dtype)
                cache.pos[:, :S] = positions
                cache.score[:, :S] = dens
                cache.length.copy_(lengths)
    x_last = rms_norm(x[:, -1, :], params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x_last), x_last, caches


def prefill_lane(params, cfg: ModelConfig, inputs: dict, caches: ModelCaches, lane: int, *, spec: CacheSpec, chunk: int = 1024):
    """Prefill ONE lane of a batched cache: the prompt runs through a fresh
    single-lane cache, which then overwrites lane ``lane`` in place.
    Returns (logits_last [1,V], hidden_last [1,d], caches)."""
    dev = caches.groups[0].length.device
    fresh = init_caches(cfg, 1, spec, device=dev)
    logits, hidden, fresh = prefill(params, cfg, inputs, fresh, spec=spec, chunk=chunk)
    write_lane(caches, fresh, lane)
    return logits, hidden, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, inputs: dict, caches: ModelCaches, *, spec: CacheSpec):
    """One-token decode. inputs: {"tokens": [B] int32, "positions": [B]}.
    Updates ``caches`` in place; returns (logits [B,V] f32, hidden [B,d], caches)."""
    x = _embed(params, cfg, inputs["tokens"])[:, None, :]
    positions = inputs["positions"]
    for g, grp in enumerate(cfg.layer_groups()):
        pg, cg = params["groups"][g], caches.groups[g]
        for i in range(grp.count):
            p_layer = _layer(pg, i)
            cache = layer_cache(cg, i)
            h = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            if spec.kind == "synapse":
                y, _, _ = synapse_lib.synapse_decode(p_layer["attn"], cfg, h, cache, positions, spec.policy)
            else:
                y, _, _ = attention.attention_decode_full(p_layer["attn"], cfg, h, cache, positions)
            x = _radd(x, y)
            h = rms_norm(x, p_layer["ln2"], cfg.norm_eps)
            x = _radd(x, swiglu(p_layer["mlp"], h))
    hidden = rms_norm(x[:, 0, :], params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, hidden), hidden, caches
