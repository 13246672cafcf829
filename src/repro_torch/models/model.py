"""Unified model: parameters, caches, forward, prefill and one-token decode
for every architecture of :mod:`repro_torch.configs`.

Port of the JAX package's ``repro.models.model``. Parameters are a nested
dict with the reference's layout — ``embed`` [V, d] (absent for the
encoder-only model), ``groups[g]`` with every leaf stacked on a leading
layer axis, ``shared_attn`` for the hybrid's shared block, ``final_norm``,
and ``head`` unless embeddings are tied — so :mod:`repro_torch.bridge`
carries JAX weights over leaf by leaf. The layer stack runs as the
reference's *segments*: a run of layers of one group, then, in the hybrid
(zamba2), one invocation of the shared attention block with its own LoRA
and its own slice of the stacked shared cache. The published Zamba2
(``cfg.hybrid_layer_ids``) keeps its ``n_shared_blocks`` blocks stacked
under ``shared_attn`` and each invocation's adapter and linear under
``hybrid``; an invocation's output enters only the next Mamba2 layer's
norm input, as in ``transformers``' ``Zamba2HybridLayer``. Layers are a Python loop
over the stacked leaves. Prefill and decode update the caches IN PLACE
(the reference donates them).
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import trace
from repro_torch.core import synapse as synapse_lib
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention, cache as cache_lib, mamba2, mla, moe, rwkv6
from repro_torch.models.config import LayerGroup, ModelConfig
from repro_torch.models.layers import (adapted_geglu, dense_init, embed_init, embed_lookup, gather_fsdp, replicate_dims,
                                      rms_norm, swiglu, swiglu_init)


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
    layer group and, for the hybrid, the shared block's caches stacked per
    invocation, [n_inv, B, ...] (None otherwise).

    The reference treats this as a pytree, so every map over it carries
    ``shared`` along; here :meth:`parts` and :meth:`map` are that one
    traversal, and every helper that walks the caches goes through them."""

    groups: tuple
    shared: object = None

    def parts(self) -> list:
        """Every stacked cache: the groups' in order, then the shared one."""
        return [*self.groups, *(() if self.shared is None else (self.shared,))]

    def map(self, fn) -> "ModelCaches":
        """A new ModelCaches with ``fn`` applied to each stacked cache."""
        return ModelCaches(groups=tuple(fn(c) for c in self.groups),
                           shared=None if self.shared is None else fn(self.shared))

    def tensors(self) -> list:
        return [a for c in self.parts() for a in cache_lib.tensors(c)]


# ---------------------------------------------------------------------------
# segment plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Segment:
    group: int         # index into layer groups / params["groups"]
    start: int         # first layer within the group's stacked params
    count: int
    shared_after: int  # shared-attn invocation after this segment, or -1


def build_segments(cfg: ModelConfig) -> list[Segment]:
    segs: list[Segment] = []
    groups = cfg.layer_groups()
    if cfg.hybrid_layer_ids:
        # invocation i runs before the layer at depth hybrid_layer_ids[i]
        start = 0
        for inv, depth in enumerate(cfg.hybrid_layer_ids):
            segs.append(Segment(0, start, depth - start, inv))
            start = depth
        return segs + [Segment(0, start, cfg.n_layers - start, -1)]
    if cfg.shared_attn_every > 0:
        assert len(groups) == 1
        every, total = cfg.shared_attn_every, groups[0].count
        start = inv = 0
        while start < total:
            count = min(every, total - start)
            has_inv = (start + count) % every == 0 and inv < cfg.n_shared_attn_invocations
            segs.append(Segment(0, start, count, inv if has_inv else -1))
            if has_inv:
                inv += 1
            start += count
        return segs
    return [Segment(g, 0, grp.count, -1) for g, grp in enumerate(groups)]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _block_init(gen, cfg: ModelConfig, grp: LayerGroup, dtype, device):
    L = (grp.count,)
    ones = lambda: torch.ones((*L, cfg.d_model), dtype=dtype, device=device)
    if grp.kind == "attn":
        p = {"ln1": ones(), "ln2": ones()}
        if cfg.attn_kind == "mla":
            p["attn"] = mla.mla_init(gen, cfg, dtype, device, lead=L)
        else:
            p["attn"] = attention.attn_init(gen, cfg, dtype, device, lead=L)
        if grp.mlp == "moe":
            p["mlp"] = moe.moe_init(gen, cfg, dtype, device, lead=L)
        else:
            # dense MLP; inside a MoE model (first_k_dense) it uses dense_d_ff
            dff = cfg.d_ff if not cfg.is_moe else (cfg.dense_d_ff or cfg.d_ff * cfg.experts_per_token)
            p["mlp"] = swiglu_init(gen, cfg.d_model, dff, dtype, device, lead=L)
        return p
    if grp.kind == "mamba2":
        return {"ln": ones(), "mixer": mamba2.mamba2_init(gen, cfg, dtype, device, lead=L)}
    if grp.kind == "rwkv6":
        return {"ln1": ones(), "tmix": rwkv6.rwkv6_tmix_init(gen, cfg, dtype, device, lead=L),
                "ln2": ones(), "cmix": rwkv6.rwkv6_cmix_init(gen, cfg, dtype, device, lead=L)}
    raise ValueError(grp.kind)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless ``device="cpu"``). The layout matches the reference's
    ``init_params``; the values do not (a different generator). On the
    ``meta`` device the tree has shapes and dtypes and no storage (meta
    tensors take no generator)."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dtype = torch_dtype(cfg.param_dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    params: dict = {}
    if cfg.embed_inputs or not cfg.is_encoder_only:
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    params["groups"] = [_block_init(gen, cfg, grp, dtype, device) for grp in cfg.layer_groups()]
    if cfg.hybrid_layer_ids:
        params.update(_hybrid_init(gen, cfg, dtype, device))
    elif cfg.shared_attn_every > 0:
        params["shared_attn"] = {
            "ln1": ones(),
            "attn": attention.attn_init(gen, cfg, dtype, device, n_lora=cfg.n_shared_attn_invocations),
            "ln2": ones(),
            "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
        }
    params["final_norm"] = ones()
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device)
    return params


def _hybrid_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """The published Zamba2's shared blocks, stacked [n_shared_blocks, ...]
    over inputs [stream; embeddings], and per invocation [n_inv, ...] its
    linear (``w_out``) and its adapter on the MLP's gate_up (``lora_b``
    starts at zero)."""
    d, nb, ni, r = cfg.d_model, cfg.n_shared_blocks, cfg.n_shared_attn_invocations, cfg.shared_mlp_lora_rank
    a = 2 * d
    ones = lambda n: torch.ones((nb, n), dtype=dtype, device=device)
    hybrid = {"w_out": dense_init(gen, d, d, dtype, device, lead=(ni,)),
              "lora_a": dense_init(gen, d, r, dtype, device, lead=(ni,)),
              "lora_b": torch.zeros((ni, r, 2 * cfg.d_ff), dtype=dtype, device=device)}
    return {"shared_attn": {"ln1": ones(a), "attn": attention.attn_init(gen, cfg, dtype, device, lead=(nb,), d_in=a),
                           "ln2": ones(d), "mlp": swiglu_init(gen, d, cfg.d_ff, dtype, device, lead=(nb,))},
            "hybrid": hybrid}


def abstract_params(cfg: ModelConfig):
    """The params' shapes and dtypes on the ``meta`` device, no storage
    (the dry run's counterpart of the reference's ``jax.eval_shape``)."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# activation placement anchors
# ---------------------------------------------------------------------------
# The placement of the [B, S, d] residual stream between layers, set by the
# launch entry points before a step on a mesh: the reference's
# ``_ACT_SPEC``. A spec names the axes of each dim (None, an axis name or a
# tuple of them), as ``repro_torch.launch.sharding`` does.
_ACT_SPEC = None


def set_activation_sharding(spec):
    """spec: the per-dim axes of [B, S, d] activations, e.g. (("data",),
    "model", None), or None to disable."""
    global _ACT_SPEC
    _ACT_SPEC = None if spec is None else tuple(spec)


def constrain_to(x, spec):
    """``x`` (a DTensor) redistributed to the placements of ``spec`` on its
    own mesh; an axis that does not divide its dim is dropped, as the
    param rules drop it. A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch import sharding  # lazy: sharding imports this module

    mesh = x.device_mesh
    want = sharding.placements(sharding.fit_spec(mesh, x.shape, spec), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def _whole_seq(x):
    """The stream [B, S, d] with its sequence whole on every rank: the
    anchors split the sequence over ``model`` between layers (what a
    rematerialised layer keeps for the backward pass), and each block
    gathers it before its projections, as sequence parallelism does."""
    return replicate_dims(x, 1) if x.dim() == 3 else x


def _constrain(x):
    if _ACT_SPEC is None:
        return x
    spec = _ACT_SPEC
    if x.dim() == 2:  # [B, d] decode stream
        spec = (spec[0], None)
    return constrain_to(x, spec)


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


def _gathered(params):
    """On a mesh, a block's weights whole over the data axes (FSDP's gather
    before use, still split over ``model``); as they are otherwise. Inside
    a rematerialised layer the backward pass gathers again."""
    return tree_map(gather_fsdp, params)


def _radd(x, y):
    """Residual add keeping the stream dtype."""
    return x + y.to(x.dtype)


def _head(params, cfg: ModelConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else gather_fsdp(params["head"])
    return (x @ head.to(x.dtype)).float()


def check_servable(cfg: ModelConfig, entry: str) -> None:
    """Refuse the families the reference's serving entry points cannot run.

    ``CortexEngine`` and ``BatchServer`` prefill token prompts and decode
    with one rope position per lane ([B]), as the reference's do. The
    encoder-only model has no prefill or decode (the reference asserts at
    the first prefill), and M-RoPE decode needs [B, 3] positions (the
    reference's engine and server fail at their first decode step); the
    port refuses both at construction instead. Both still run through the
    model's own functions (``forward``; ``prefill``/``decode_step`` with
    [B, 3, S]/[B, 3] positions)."""
    if cfg.is_encoder_only:
        raise ValueError(f"{entry}: {cfg.name} is encoder-only: it has a forward, no prefill or decode")
    if cfg.rope_kind == "mrope":
        raise ValueError(f"{entry}: {cfg.name} uses M-RoPE, whose decode takes [B, 3] positions; the "
                         f"serving entry points decode with one position per lane, as the reference's do")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, spec: CacheSpec, *, device) -> ModelCaches:
    dtype = torch_dtype(cfg.compute_dtype)
    kw = dict(device=device)
    attn_cache = lambda lead: (
        cache_lib.init_synapse_cache(cfg, batch, spec.n_landmarks, spec.window, spec.n_inject, dtype, lead=lead, **kw)
        if spec.kind == "synapse" else
        cache_lib.init_full_cache(cfg, batch, spec.capacity, dtype, lead=lead, **kw))
    out = []
    for grp in cfg.layer_groups():
        L = (grp.count,)
        if grp.kind == "attn":
            c = (cache_lib.init_mla_cache(cfg, batch, spec.capacity, dtype, lead=L, **kw)
                 if cfg.attn_kind == "mla" else attn_cache(L))
        elif grp.kind == "mamba2":
            c = cache_lib.init_mamba2_state(cfg, batch, dtype, lead=L, **kw)
        else:
            c = cache_lib.init_rwkv6_state(cfg, batch, dtype, lead=L, **kw)
        out.append(c)
    shared = attn_cache((cfg.n_shared_attn_invocations,)) if cfg.has_shared_block else None
    return ModelCaches(groups=tuple(out), shared=shared)


def layer_cache(c, i: int):
    """Views of layer ``i`` of a stacked cache: writes reach the stack."""
    return cache_lib.map_cache(lambda a: a[i], c)


def lane_caches(caches: ModelCaches, lane: int) -> ModelCaches:
    """One lane of the stacked caches, keeping the lane axis (axis 1; axis
    0 is the stacked layer dim), as views."""
    return caches.map(lambda c: cache_lib.map_cache(lambda a: a[:, lane:lane + 1], c))


def write_lane(caches: ModelCaches, part: ModelCaches, lane: int, *, recurrent: bool | None = None) -> None:
    """In place: ``lane`` of the stacked caches takes the values of the
    one-lane caches ``part``. A part shorter along a slot axis (an MLA
    river cache spawned into a longer side cache) fills the leading slots,
    as the reference's ``dynamic_update_slice`` does. ``recurrent``: only
    the recurrent states (True), only the attention caches (False), or
    both (None)."""
    for c, p in zip(caches.parts(), part.parts()):
        if recurrent is not None and cache_lib.is_recurrent(c) != recurrent:
            continue
        for a, b in zip(cache_lib.tensors(c), cache_lib.tensors(p)):
            cache_lib.leading(a[:, lane:lane + 1], b.shape).copy_(b)


def held_bytes(caches: ModelCaches) -> tuple[int, int]:
    """(recurrent state bytes, attention cache bytes) the stacked caches
    hold, from their shapes (no device value is read)."""
    out = [0, 0]
    for c in caches.parts():
        out[0 if cache_lib.is_recurrent(c) else 1] += cache_lib.cache_bytes(c)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _inputs(params, cfg: ModelConfig, inputs: dict):
    """The residual stream ([B, S, d], or [B, d] for one decode token) in
    the compute dtype, from ``embeds`` or from ``tokens`` through the
    embedding table."""
    if "embeds" in inputs:
        return inputs["embeds"].to(torch_dtype(cfg.compute_dtype))
    return embed_lookup(inputs["tokens"].long(), params["embed"]).to(torch_dtype(cfg.compute_dtype))


def _positions(cfg: ModelConfig, inputs: dict, B: int, S: int, device):
    """[B, S] positions (0..S-1 unless given), [B, 3, S] for M-RoPE."""
    if "positions" in inputs:
        return inputs["positions"]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return pos[:, None, :].expand(B, 3, S) if cfg.rope_kind == "mrope" else pos


def _last_query(block_params, cfg: ModelConfig, x_in, positions, lora_idx=None):
    """The last position's rotated query [B,H,D] (one token's work).
    block_params: a block dict with "ln1" and "attn"; x_in: its input."""
    h = rms_norm(x_in[:, -1:, :], block_params["ln1"], cfg.norm_eps)
    q, _, _ = attention._project_qkv(block_params["attn"], cfg, h, lora_idx)
    q = attention._rotate(cfg, q, positions[..., -1:])
    return q[:, 0]


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "drop_frac": z}


def _attn_block_fwd(p, cfg: ModelConfig, mlp_kind: str, x, positions, chunk):
    """Returns (x_out, aux, kv): kv is (k_rot, v), or (ckv, krope) for MLA."""
    x = _whole_seq(x)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        y, kv = mla.mla_forward(p["attn"], cfg, h, positions, chunk=chunk)
    else:
        y, kv = attention.attention_forward(p["attn"], cfg, h, positions, chunk=chunk)
    x = _radd(x, y)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mlp_kind == "moe":
        y, aux = moe.moe_forward(p["mlp"], cfg, h)
    else:
        y, aux = swiglu(p["mlp"], h), _zero_aux(x.device)
    return _radd(x, y), aux, kv


def _shared_attn_fwd(p, cfg: ModelConfig, x, positions, lora_idx: int, chunk):
    p, x = _gathered(p), _whole_seq(x)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, kv = attention.attention_forward(p["attn"], cfg, h, positions, lora_idx=lora_idx, chunk=chunk)
    x = _radd(x, y)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return _radd(x, swiglu(p["mlp"], h)), kv


def _hybrid_parts(params, cfg: ModelConfig, inv: int):
    """(the shared block, the invocation's adapter and linear) that the
    published hybrid's invocation ``inv`` runs."""
    return _gathered(_layer(params["shared_attn"], inv % cfg.n_shared_blocks)), _gathered(_layer(params["hybrid"], inv))


def _hybrid_input(cfg: ModelConfig, x, emb):
    """The shared block's input: [stream; the token's embeddings]."""
    return torch.cat([x, emb], dim=-1)


def _hybrid_out(sp, hp, cfg: ModelConfig, y):
    """The block's MLP over its attention output ``y`` (no residual), then
    the invocation's linear: what the next Mamba2 layer adds to its norm input."""
    h = rms_norm(y, sp["ln2"], cfg.norm_eps)
    return adapted_geglu(sp["mlp"], h, hp["lora_a"], hp["lora_b"]) @ hp["w_out"]


def _hybrid_block_fwd(sp, hp, cfg: ModelConfig, x_in, positions, chunk):
    """One invocation of the published shared block over a sequence:
    (its output for the next Mamba2 layer, (k_rot, v))."""
    h = rms_norm(x_in, sp["ln1"], cfg.norm_eps)
    y, kv = attention.attention_forward(sp["attn"], cfg, h, positions, chunk=chunk)
    return _hybrid_out(sp, hp, cfg, y), kv


def _with_extra(x, extra):
    """A Mamba2 layer's norm input: the stream, plus the output of the
    shared block invoked before it (the stream itself does not take it)."""
    return x if extra is None else _radd(x, extra)


def _mamba2_fwd_state(p_layer, cfg: ModelConfig, x, extra=None):
    """Mamba2 layer forward that also returns the terminal decode state."""
    x = _whole_seq(x)
    h = rms_norm(_with_extra(x, extra), p_layer["ln"], cfg.norm_eps)
    y, state = mamba2.mamba2_forward(p_layer["mixer"], cfg, h, return_state=True)
    return _radd(x, y), state


def _rwkv6_fwd_state(p_layer, cfg: ModelConfig, x):
    x = _whole_seq(x)
    h = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
    y, (shift_tm, wkv) = rwkv6.rwkv6_tmix_forward(p_layer["tmix"], cfg, h)
    x = _radd(x, y)
    h2 = rms_norm(x, p_layer["ln2"], cfg.norm_eps)
    y2, shift_cm = rwkv6.rwkv6_cmix_forward(p_layer["cmix"], cfg, h2)
    return _radd(x, y2), cache_lib.RWKV6State(shift_tm=shift_tm, shift_cm=shift_cm, wkv=wkv)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------
def _layer_fwd(p_layer, x, extra=None, *, cfg: ModelConfig, grp: LayerGroup, positions, chunk):
    """One layer of a group: (x_out, aux), aux None but for attention
    blocks (whose MLP may be a MoE). ``extra``: the published hybrid's
    block output, added to a Mamba2 layer's norm input."""
    p_layer, x = _gathered(p_layer), _whole_seq(x)
    if grp.kind == "attn":
        x, aux, _ = _attn_block_fwd(p_layer, cfg, grp.mlp, x, positions, chunk)
        return x, aux
    if grp.kind == "mamba2":
        h = rms_norm(_with_extra(x, extra), p_layer["ln"], cfg.norm_eps)
        return _radd(x, mamba2.mamba2_forward(p_layer["mixer"], cfg, h)), None
    return _rwkv6_fwd_state(p_layer, cfg, x)[0], None


# the products "dots" keeps: 2-D matmuls (a [B, S, d] x [d, f] product is
# one); batched products (einsums over heads, experts) are recomputed, as
# JAX's checkpoint_dots_with_no_batch_dims keeps no batched dot
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` as the reference's ``jax.checkpoint`` of the layer body: while
    autograd records (training), its activations are recomputed in the
    backward pass, all of them ("full") or all but the 2-D matmuls'
    outputs ("dots"). Without grad (eval, serving) it runs as it is."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def forward(params, cfg: ModelConfig, inputs: dict, *, chunk: int = 1024):
    """Training/eval forward over a whole sequence (the encoder's only
    entry point).

    inputs: {"tokens": [B,S] int32} or {"embeds": [B,S,d]}, optional
    "positions" ([B,S], or [B,3,S] for M-RoPE). Returns (logits [B,S,V]
    f32, aux) with the MoE aux terms summed over layers and
    ``hidden_last`` [B, d]. Under autograd each layer is rematerialised as
    ``cfg.remat`` and ``cfg.remat_policy`` say; the values are the same.
    """
    params = cast_params(params, cfg)
    x = emb = _inputs(params, cfg, inputs)
    B, S = x.shape[:2]
    positions = _positions(cfg, inputs, B, S, x.device)
    groups = cfg.layer_groups()
    aux_total = _zero_aux(x.device)
    extra = None
    for seg in build_segments(cfg):
        grp, pg = groups[seg.group], params["groups"][seg.group]
        layer = _remat(cfg, functools.partial(_layer_fwd, cfg=cfg, grp=grp, positions=positions, chunk=chunk))
        for i in range(seg.start, seg.start + seg.count):
            x, aux = layer(_layer(pg, i), _constrain(x), extra)
            x, extra = _constrain(x), None
            if aux is not None:
                aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        if seg.shared_after >= 0 and cfg.hybrid_layer_ids:
            sp, hp = _hybrid_parts(params, cfg, seg.shared_after)
            x = _whole_seq(x)
            extra, _ = _hybrid_block_fwd(sp, hp, cfg, _hybrid_input(cfg, x, _whole_seq(emb)), positions, chunk)
        elif seg.shared_after >= 0:
            x, _ = _shared_attn_fwd(params["shared_attn"], cfg, x, positions, seg.shared_after, chunk)
    x = rms_norm(_whole_seq(x), params["final_norm"], cfg.norm_eps)
    aux_total["hidden_last"] = x[:, -1, :]
    # on a mesh the logits take the stream's placement, the vocab whole:
    # the loss's log-softmax and gather then run on each rank's tokens
    return _constrain(_head(params, cfg, x)), aux_total


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _fill_full_cache(cache: cache_lib.FullCache, k, v, positions, length, score=None):
    """In place: write the [B,S,...] prefix into a FullCache from slot 0."""
    S = k.shape[1]
    cache.k[:, :S] = k.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    cache.pos[:, :S] = positions
    if score is not None:
        cache.score[:, :S] = score
    cache.length.copy_(length)


def _fill_attn_cache(cfg: ModelConfig, spec: CacheSpec, cache, kv, q_last, positions, lengths, *, with_score: bool):
    """In place: one attention layer's (or invocation's) cache from the
    prompt's rotated K/V; synapse caches compress them at once with
    ``q_last`` as the paper's Q_t."""
    k_rot, v = kv
    if spec.kind == "synapse":
        full = cache_lib.FullCache(
            k_rot.to(cache.lm_k.dtype), v.to(cache.lm_v.dtype), positions.to(torch.int32),
            torch.zeros(positions.shape, dtype=torch.float32, device=k_rot.device), lengths,
        )
        comp = synapse_lib.compress(cfg, full, q_last, cache.n_landmarks, cache.window, cache.n_inject, spec.policy)
        cache_lib.copy_into(cache, comp)
        return
    dens = None
    if with_score:
        dens = synapse_lib.attention_density(
            q_last, k_rot.to(cache.k.dtype), torch.ones(k_rot.shape[:2], dtype=torch.bool, device=k_rot.device),
            cfg.attn_scale)
    _fill_full_cache(cache, k_rot, v, positions, lengths, score=dens)


def prefill(params, cfg: ModelConfig, inputs: dict, caches: ModelCaches, *, spec: CacheSpec, chunk: int = 1024):
    """Run the prompt through the stack, filling ``caches`` in place from
    slot 0. inputs: {"tokens": [B,S]} or {"embeds": [B,S,d]}, optional
    "positions". Attention caches of kind "synapse" are compressed at once
    by hybrid landmark selection, with the last token's query as the
    paper's Q_t; recurrent states start fresh. Returns (logits_last [B,V]
    f32, hidden_last [B,d], caches).
    """
    assert not cfg.is_encoder_only, "encoder-only archs have no decode/prefill"
    x = emb = _inputs(params, cfg, inputs)
    B, S = x.shape[:2]
    positions = _positions(cfg, inputs, B, S, x.device)
    pos_scalar = positions[:, 0, :] if cfg.rope_kind == "mrope" else positions
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    groups = cfg.layer_groups()
    extra = None
    for seg in build_segments(cfg):
        grp, pg, cg = groups[seg.group], params["groups"][seg.group], caches.groups[seg.group]
        for i in range(seg.start, seg.start + seg.count):
            p_layer, cache = _gathered(_layer(pg, i)), layer_cache(cg, i)
            x = _constrain(x)
            if grp.kind == "mamba2":
                x, state = _mamba2_fwd_state(p_layer, cfg, x, extra)
                extra = None
                cache_lib.copy_into(cache, state)
                continue
            if grp.kind == "rwkv6":
                x, state = _rwkv6_fwd_state(p_layer, cfg, x)
                cache_lib.copy_into(cache, state)
                continue
            carry = x
            x, _, kv = _attn_block_fwd(p_layer, cfg, grp.mlp, carry, positions, chunk)
            if cfg.attn_kind == "mla":
                ckv, krope = kv
                cache.ckv[:, :S] = ckv.to(cache.ckv.dtype)
                cache.krope[:, :S] = krope.to(cache.krope.dtype)
                cache.length.copy_(lengths)
                continue
            q_last = _last_query(p_layer, cfg, carry, positions)
            _fill_attn_cache(cfg, spec, cache, kv, q_last, pos_scalar, lengths, with_score=True)
        if seg.shared_after >= 0 and cfg.hybrid_layer_ids:
            inv = seg.shared_after
            sp, hp = _hybrid_parts(params, cfg, inv)
            x_in = _hybrid_input(cfg, _whole_seq(x), _whole_seq(emb))
            extra, kv = _hybrid_block_fwd(sp, hp, cfg, x_in, positions, chunk)
            q_last = _last_query(sp, cfg, x_in, positions) if spec.kind == "synapse" else None
            _fill_attn_cache(cfg, spec, layer_cache(caches.shared, inv), kv, q_last, pos_scalar, lengths,
                             with_score=False)
        elif seg.shared_after >= 0:
            inv, x_before = seg.shared_after, x
            x, kv = _shared_attn_fwd(params["shared_attn"], cfg, x, positions, inv, chunk)
            q_last = (_last_query(params["shared_attn"], cfg, x_before, positions, lora_idx=inv)
                      if spec.kind == "synapse" else None)
            _fill_attn_cache(cfg, spec, layer_cache(caches.shared, inv), kv, q_last, pos_scalar, lengths,
                             with_score=False)
    x_last = rms_norm(x[:, -1, :], params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x_last), x_last, caches


def prefill_lane(params, cfg: ModelConfig, inputs: dict, caches: ModelCaches, lane: int, *, spec: CacheSpec, chunk: int = 1024):
    """Prefill ONE lane of a batched cache: the prompt runs through a fresh
    single-lane cache, which then overwrites lane ``lane`` in place.
    Returns (logits_last [1,V], hidden_last [1,d], caches)."""
    dev = caches.tensors()[0].device
    fresh = init_caches(cfg, 1, spec, device=dev)
    logits, hidden, fresh = prefill(params, cfg, inputs, fresh, spec=spec, chunk=chunk)
    write_lane(caches, fresh, lane)
    return logits, hidden, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _attn_decode(p_attn, cfg: ModelConfig, spec: CacheSpec, h, cache, positions):
    if isinstance(cache, cache_lib.MLACache):
        y, _, _ = mla.mla_decode(p_attn, cfg, h, cache, positions)
    elif spec.kind == "synapse":
        y, _, _ = synapse_lib.synapse_decode(p_attn, cfg, h, cache, positions, spec.policy)
    else:
        y, _, _ = attention.attention_decode_full(p_attn, cfg, h, cache, positions)
    return y


def decode_step(params, cfg: ModelConfig, inputs: dict, caches: ModelCaches, *, spec: CacheSpec):
    """One-token decode. inputs: {"tokens": [B] int32} or {"embeds": [B,d]},
    and "positions": [B] (or [B,3] for M-RoPE). Updates ``caches`` in place;
    returns (logits [B,V] f32, hidden [B,d], caches). The reference
    variant's shared block decodes without its qkv LoRA, as in the
    reference; the published hybrid's blocks apply their MLP adapters."""
    assert not cfg.is_encoder_only, "encoder-only archs have no decode/prefill"
    x = emb = _inputs(params, cfg, inputs)[:, None, :]
    positions = inputs["positions"]
    groups = cfg.layer_groups()
    extra = None
    for seg in build_segments(cfg):
        grp, pg, cg = groups[seg.group], params["groups"][seg.group], caches.groups[seg.group]
        run = (trace.span("decode.mamba", layer=seg.start, count=seg.count) if grp.kind == "mamba2"
               else contextlib.nullcontext())
        with run:
            x = _decode_run(pg, cg, cfg, grp, spec, seg, x, extra, positions)
        extra = None
        if seg.shared_after >= 0 and cfg.hybrid_layer_ids:
            inv = seg.shared_after
            with trace.span("decode.shared", invocation=inv, block=inv % cfg.n_shared_blocks):
                sp, hp = _hybrid_parts(params, cfg, inv)
                h = rms_norm(_hybrid_input(cfg, x, emb), sp["ln1"], cfg.norm_eps)
                with trace.span("decode.attn", shared=inv):
                    att = _attn_decode(sp["attn"], cfg, spec, h, layer_cache(caches.shared, inv), positions)
                extra = _hybrid_out(sp, hp, cfg, att)
        elif seg.shared_after >= 0:
            sp = _gathered(params["shared_attn"])
            h = rms_norm(x, sp["ln1"], cfg.norm_eps)
            with trace.span("decode.attn", shared=seg.shared_after):
                att = _attn_decode(sp["attn"], cfg, spec, h, layer_cache(caches.shared, seg.shared_after), positions)
            x = _radd(x, att)
            h = rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = _radd(x, swiglu(sp["mlp"], h))
    hidden = rms_norm(x[:, 0, :], params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, hidden), hidden, caches


def _decode_run(pg, cg, cfg: ModelConfig, grp: LayerGroup, spec: CacheSpec, seg: Segment, x, extra, positions):
    """One token through a segment's run of layers, caches in place;
    ``extra`` (the published hybrid's block output) enters the first
    Mamba2 layer's norm input. Returns x."""
    for i in range(seg.start, seg.start + seg.count):
        p_layer, cache = _gathered(_layer(pg, i)), layer_cache(cg, i)
        if grp.kind == "attn":
            h = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            with trace.span("decode.attn", layer=i):
                att = _attn_decode(p_layer["attn"], cfg, spec, h, cache, positions)
            x = _radd(x, att)
            h = rms_norm(x, p_layer["ln2"], cfg.norm_eps)
            y = moe.moe_forward(p_layer["mlp"], cfg, h)[0] if grp.mlp == "moe" else swiglu(p_layer["mlp"], h)
            x = _radd(x, y)
        elif grp.kind == "mamba2":
            h = rms_norm(_with_extra(x, extra), p_layer["ln"], cfg.norm_eps)
            extra = None
            y, state = mamba2.mamba2_decode(p_layer["mixer"], cfg, h, cache)
            if state is not cache:  # the card's step wrote the cache in place
                cache_lib.copy_into(cache, state)
            x = _radd(x, y)
        else:
            h = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            y, state = rwkv6.rwkv6_tmix_decode(p_layer["tmix"], cfg, h, cache)
            x = _radd(x, y)
            h = rms_norm(x, p_layer["ln2"], cfg.norm_eps)
            y, state = rwkv6.rwkv6_cmix_decode(p_layer["cmix"], cfg, h, state)
            cache_lib.copy_into(cache, state)
            x = _radd(x, y)
    return x
