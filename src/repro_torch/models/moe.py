"""Mixture-of-Experts FFN with capacity-based sort dispatch.

Port of the JAX package's ``repro.models.moe`` (qwen3-moe: 128 experts,
top-8, no shared expert; deepseek-v2: 160 experts, top-6, 2 shared experts,
the leading dense layer handled by the model). Tokens are argsorted by
their expert (a stable sort) and placed into a static ``[E, C, d]`` buffer
of capacity C; overflow is dropped and counted for the aux terms. The
expert matmuls are batched products over the buffer, as in the reference:
every expert runs over its C slots whether or not they hold a token.

``torch.topk`` promises no order among tied values; the reference's
``lax.top_k`` takes the lower expert index first. :func:`top_k` sorts
stably so the port picks the same experts in the same order. Nothing here
reads a device value on the host, so a decode step stays free of syncs.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, gather_fsdp, on_replicas, swiglu, swiglu_init


def _constrain_ep(x, expert_dim: int):
    """Pin the expert dim of dispatch buffers to the model axis (expert
    parallelism), the batch dim to the activations' batch axes: without it
    the expert weights would be gathered per layer. A no-op unless an
    activation spec is set and ``x`` is a DTensor."""
    from repro_torch.models import model as model_lib  # lazy: no import cycle

    spec = model_lib._ACT_SPEC
    if spec is None:
        return x
    axes = [None] * x.dim()
    axes[0] = spec[0]          # batch axes
    axes[expert_dim] = "model"
    return model_lib.constrain_to(x, axes)


def moe_init(gen, cfg: ModelConfig, dtype, device, *, lead=()):
    E, dm, dff = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": (torch.randn((*lead, dm, E), generator=gen, device=device) * 0.02).to(dtype),
        "experts": {
            "gate": dense_init(gen, dm, dff, dtype, device, lead=(*lead, E)),
            "up": dense_init(gen, dm, dff, dtype, device, lead=(*lead, E)),
            "down": dense_init(gen, dff, dm, dtype, device, lead=(*lead, E)),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, dm, cfg.n_shared_experts * cfg.d_ff, dtype, device, lead=lead)
    return p


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index (``jax.lax.top_k``'s order)."""
    idx = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    return torch.gather(probs, -1, idx), idx


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token / cfg.n_experts * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _route(p, cfg: ModelConfig, x):
    """Router softmax and the renormalised top-k gates: (probs, gates, ids)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.experts_per_token)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_ids


def _experts(ex, buf, pin=lambda t: t):
    """SwiGLU of every expert over its slots: [..., E, C, dm] -> same;
    ``pin`` places the hidden and the output buffers."""
    cast = lambda a: gather_fsdp(a).to(buf.dtype)
    h = F.silu(torch.einsum("...ecd,edf->...ecf", buf, cast(ex["gate"]))) * torch.einsum(
        "...ecd,edf->...ecf", buf, cast(ex["up"]))
    return pin(torch.einsum("...ecf,efd->...ecd", pin(h), cast(ex["down"])))


def _aux(probs, expert_ids, kept, E: int, K: int, token_axes):
    frac_tokens = F.one_hot(expert_ids.long(), E).float().mean(dim=token_axes) * K
    frac_probs = probs.mean(dim=token_axes[:-1])
    return {"lb_loss": E * torch.sum(frac_tokens * frac_probs),
            "drop_frac": 1.0 - kept.float().mean()}


def moe_forward(p, cfg: ModelConfig, x):
    """x: [B, S, dm] -> (y, aux) with the load-balance loss and the drop
    fraction. Prefill (S > 1) dispatches per lane when
    ``cfg.moe_dispatch == "per_lane"``; decode always takes the global
    path, as in the reference."""
    if cfg.moe_dispatch == "per_lane" and x.shape[1] > 1:
        return _moe_per_lane(p, cfg, x)
    return _moe_global(p, cfg, x)


def _to_slots(xt, sorted_e, pos_in_e, src_token, *, E: int, C: int):
    """The [E, C + 1, dm] dispatch buffer. The reference's scatter drops
    the overflow: here it lands in a spare slot C, which is cut off (no
    host read of how many were dropped)."""
    buf = torch.zeros((E, C + 1, xt.shape[-1]), dtype=xt.dtype, device=xt.device)
    buf[sorted_e, torch.clamp(pos_in_e, max=C)] = xt[src_token]
    return buf


def _from_slots(out_buf, sorted_e, pos_in_e, kept, order, *, C: int):
    """Each assignment's expert output, in the assignments' own order
    (zero where it overflowed)."""
    gathered = out_buf[sorted_e, torch.clamp(pos_in_e, max=C - 1)]
    gathered = torch.where(kept[:, None], gathered, torch.zeros((), dtype=gathered.dtype, device=out_buf.device))
    unsorted = torch.empty_like(gathered)
    unsorted[order] = gathered
    return unsorted


def _moe_global(p, cfg: ModelConfig, x):
    """One flat stable sort over the B*S*K assignments into [E, C, dm].
    The sort spans every token: on a mesh the dispatch and the combine run
    on every rank's whole copy."""
    B, S, dm = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, dm)
    probs, gate_vals, expert_ids = _route(p, cfg, xt)           # [T,E], [T,K], [T,K]

    C = _capacity(cfg, T)
    flat_e = expert_ids.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = F.one_hot(flat_e, E).sum(dim=0)  # (torch.bincount reads its max on the host)
    starts = torch.cumsum(counts, 0) - counts
    # rank within expert (.long(): on a mesh, the DTensor rules of this
    # integer arithmetic may hand back a float tensor)
    pos_in_e = (torch.arange(T * K, device=x.device) - starts[sorted_e]).long()
    src_token = order // K
    kept = pos_in_e < C

    buf = on_replicas(functools.partial(_to_slots, E=E, C=C), xt, sorted_e, pos_in_e, src_token)
    out_buf = _experts(p["experts"], buf[:, :C])                # [E, C, dm]
    unsorted = on_replicas(functools.partial(_from_slots, C=C), out_buf, sorted_e, pos_in_e, kept, order)
    w = gate_vals.reshape(T * K).to(xt.dtype)
    y = (unsorted * w[:, None]).reshape(T, K, dm).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + swiglu(p["shared"], xt)
    return y.reshape(B, S, dm), _aux(probs, expert_ids, kept, E, K, (0, 1))


def _moe_per_lane(p, cfg: ModelConfig, x):
    """Per-lane capacity, gather-only dispatch: buf[b, e, c] is the sorted
    token stream at starts[b, e] + c."""
    B, S, dm = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    probs, gate_vals, expert_ids = _route(p, cfg, x)            # [B,S,E], [B,S,K], [B,S,K]

    N = S * K
    C = max(8, -(-int(S * K / E * cfg.moe_capacity_factor) // 8) * 8)
    flat_e = expert_ids.reshape(B, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)          # [B,N]
    sorted_e = torch.gather(flat_e, 1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)                    # [B,E]
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = torch.arange(N, device=x.device)[None, :] - torch.gather(starts, 1, sorted_e)
    src_token = order // K                                      # [B,N]
    x_sorted = torch.gather(x, 1, src_token[..., None].expand(B, N, dm))

    slot = torch.arange(C, device=x.device)
    slot_idx = torch.clamp(starts[:, :, None] + slot[None, None, :], 0, N - 1)   # [B,E,C]
    slot_valid = slot[None, None, :] < counts[:, :, None]
    buf = torch.gather(x_sorted, 1, slot_idx.reshape(B, E * C)[..., None].expand(B, E * C, dm)).reshape(B, E, C, dm)
    buf = torch.where(slot_valid[..., None], buf, torch.zeros((), dtype=buf.dtype, device=x.device))
    pin = lambda t: _constrain_ep(t, expert_dim=1)
    out_buf = _experts(p["experts"], pin(buf), pin)             # [B,E,C,dm]

    kept = pos_sorted < C
    flat_pos = sorted_e * C + torch.clamp(pos_sorted, max=C - 1)
    gathered = torch.gather(out_buf.reshape(B, E * C, dm), 1, flat_pos[..., None].expand(B, N, dm))
    gathered = torch.where(kept[..., None], gathered, torch.zeros((), dtype=gathered.dtype, device=x.device))
    inv_order = torch.argsort(order, dim=-1)
    unsorted = torch.gather(gathered, 1, inv_order[..., None].expand(B, N, dm))
    w = gate_vals.reshape(B, N).to(x.dtype)
    y = (unsorted * w[..., None]).reshape(B, S, K, dm).sum(dim=2)
    if cfg.n_shared_experts:
        y = y + swiglu({k: a.to(x.dtype) for k, a in p["shared"].items()}, x)
    return y, _aux(probs, expert_ids, kept, E, K, (0, 1, 2))
