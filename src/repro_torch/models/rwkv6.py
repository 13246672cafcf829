"""RWKV6 "Finch" (arXiv:2404.05892): linear attention with data-dependent
decay. Port of the JAX package's ``repro.models.rwkv6``.

Time-mix recurrence per head (k-dim x v-dim matrix state S):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with the per-channel decay w_t = exp(-exp(w0 + lora_w(x'_t))) and the
data-dependent token-shift interpolation (ddlerp) through low-rank
adapters. The forward runs the recurrence token by token (f32 state);
decode is the O(1) single step. Attention-free: the synapse does not apply
(the state is already O(1)), and referential injection becomes a state
blend (:func:`repro_torch.core.injection.blend_state`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, lane_head_placements, per_shard, split_mesh



def rwkv6_tmix_init(gen, cfg: ModelConfig, dtype, device, *, lead=()):
    d, h, hs = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_size
    lm, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    uni = lambda *s: (torch.rand((*lead, *s), generator=gen, device=device) * 0.5).to(dtype)
    nrm = lambda scale, *s, dt=dtype: (torch.randn((*lead, *s), generator=gen, device=device) * scale).to(dt)
    zeros = lambda *s: torch.zeros((*lead, *s), dtype=dtype, device=device)
    return {
        "mu_x": uni(d),
        "mu": uni(5, d),
        "mix_a": nrm(0.01, 5, d, lm),
        "mix_b": zeros(5, lm, d),
        "w0": torch.full((*lead, d), -6.0, dtype=torch.float32, device=device),
        "decay_a": nrm(0.01, d, ld),
        "decay_b": zeros(ld, d),
        "u": nrm(0.1, h, hs, dt=torch.float32),
        "wr": dense_init(gen, d, d, dtype, device, lead=lead),
        "wk": dense_init(gen, d, d, dtype, device, lead=lead),
        "wv": dense_init(gen, d, d, dtype, device, lead=lead),
        "wg": dense_init(gen, d, d, dtype, device, lead=lead),
        "wo": dense_init(gen, d, d, dtype, device, lead=lead),
        "ln_x": torch.ones((*lead, d), dtype=dtype, device=device),  # per-head group norm scale
    }


def rwkv6_cmix_init(gen, cfg: ModelConfig, dtype, device, *, lead=()):
    d, dff = cfg.d_model, cfg.d_ff
    uni = lambda *s: (torch.rand((*lead, *s), generator=gen, device=device) * 0.5).to(dtype)
    return {
        "mu_k": uni(d),
        "mu_r": uni(d),
        "wk": dense_init(gen, d, dff, dtype, device, lead=lead),
        "wv": dense_init(gen, dff, d, dtype, device, lead=lead),
        "wr": dense_init(gen, d, d, dtype, device, lead=lead),
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent token shift for the 5 mix targets: 5 x [B, S, d].
    On a mesh, one product per target, not one einsum over the five: the
    einsum's placement rule may split the target dim (5) over a mesh dim
    it does not divide."""
    xx = x_prev - x
    base = x + xx * p["mu_x"]
    if split_mesh(x) is not None:
        return [x + xx * (p["mu"][i] + torch.tanh(base @ p["mix_a"][i]) @ p["mix_b"][i])
                for i in range(p["mix_a"].shape[0])]
    t = torch.tanh(torch.einsum("bsd,ndr->nbsr", base, p["mix_a"]))
    lora = torch.einsum("nbsr,nrd->nbsd", t, p["mix_b"])
    mix = p["mu"][:, None, None, :] + lora  # [5,B,S,d]
    return (x[None] + xx[None] * mix).unbind(0)


def _group_norm(x, weight, h, eps=1e-5):
    """Per-head layer norm over head_size. x: [..., d] seen as [..., h, hs]."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], h, shp[-1] // h).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * weight.float()).to(x.dtype)


def _tmix_projections(p, cfg: ModelConfig, x, x_prev):
    """Shared by forward and decode. x, x_prev: [B,S,d]."""
    B, S, d = x.shape
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(B, S, h, hs)
    k = (xk @ p["wk"]).reshape(B, S, h, hs)
    v = (xv @ p["wv"]).reshape(B, S, h, hs)
    g = F.silu(xg @ p["wg"])
    logw = p["w0"] + torch.einsum("bsr,rd->bsd", torch.tanh(xw @ p["decay_a"]), p["decay_b"]).float()
    w = torch.exp(-torch.exp(logw)).reshape(B, S, h, hs)  # decay in (0,1)
    return r, k, v, g, w


def _wkv_step(u, S_prev, rt, kt, vt, wt):
    """One recurrence step on [B,h,hs] inputs: (S_new, out [B,h,hs])."""
    kv = torch.einsum("bhk,bhv->bhkv", kt.float(), vt.float())
    u = u if u.dim() == 3 else u[None]  # [h, hs], or per lane [B, h, hs]
    out = torch.einsum("bhk,bhkv->bhv", rt.float(), S_prev + u[..., None] * kv)
    return S_prev * wt.float()[..., None] + kv, out


def _out_proj(p, y):
    """y @ wo at y's dtype: the gated f32 state readout times a bf16 weight
    is an f32 product, as JAX promotes a mixed-dtype matmul."""
    return y @ p["wo"].to(y.dtype)


def rwkv6_tmix_forward(p, cfg: ModelConfig, x, shift_state=None, wkv_state=None):
    """Full-sequence time mix. x: [B,S,d]. Returns (y, (last token, wkv state))."""
    B, S, d = x.shape
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device) if shift_state is None else shift_state[:, None, :]
    x_prev = torch.cat([prev, x[:, :-1]], dim=1)
    r, k, v, g, w = _tmix_projections(p, cfg, x, x_prev)
    St = torch.zeros((B, h, hs, hs), dtype=torch.float32, device=x.device) if wkv_state is None else wkv_state
    ys, St = _wkv_scan(p["u"], St, r, k, v, w)
    y = _group_norm(ys.reshape(B, S, d), p["ln_x"], h)
    return _out_proj(p, y * g), (x[:, -1, :], St)


def _wkv_recur(u, St, r, k, v, w):
    """The recurrence over the time dim of r, k, v, w [B,S,h,hs]:
    (outputs [B,S,h,hs] f32, final state)."""
    outs = []
    for t in range(r.shape[1]):
        St, out = _wkv_step(u, St, r[:, t], k[:, t], v[:, t], w[:, t])
        outs.append(out)
    return torch.stack(outs, dim=1), St


def _wkv_scan(u, St, r, k, v, w):
    """:func:`_wkv_recur`; on a mesh, on each rank's shards. Every (lane,
    head) recurs on its own, so the lanes go over the data axes, the heads
    over ``model`` where they divide it, and the time dim is whole on every
    rank: one gather per input, where a step-by-step run on DTensors
    would gather each time step."""
    if split_mesh(r) is None:
        return _wkv_recur(u, St, r, k, v, w)
    mesh, (seq, state) = lane_head_placements(r, r.shape[2], (2, 1))
    # u is shared by every lane: expanded to one copy a lane before the
    # split, so its gradient sums over the lanes of every rank
    u = u[None].expand(r.shape[0], *u.shape)
    return per_shard(_wkv_recur, mesh, (seq, state), (state, state, seq, seq, seq, seq), u, St, r, k, v, w)


def _wkv_decode(u, S_prev, rt, kt, vt, wt):
    """:func:`_wkv_step` of one token; on a mesh, on each rank's blocks of
    lanes and heads, as :func:`_wkv_scan` (DTensor's einsum rule may refuse
    to flatten a split head dim)."""
    if split_mesh(rt) is None:
        return _wkv_step(u, S_prev, rt, kt, vt, wt)
    mesh, (state, tok) = lane_head_placements(rt, rt.shape[1], (1, 1))
    u = u[None].expand(rt.shape[0], *u.shape)  # one copy a lane, as in _wkv_scan
    return per_shard(_wkv_step, mesh, (state, tok), (tok, state, tok, tok, tok, tok), u, S_prev, rt, kt, vt, wt)


def rwkv6_tmix_decode(p, cfg: ModelConfig, x, state: cache_lib.RWKV6State):
    """Single token. x: [B,1,d]. Returns (y, state with new shift_tm, wkv)."""
    B, _, d = x.shape
    r, k, v, g, w = _tmix_projections(p, cfg, x, state.shift_tm[:, None, :])
    S_new, out = _wkv_decode(p["u"], state.wkv, r[:, 0], k[:, 0], v[:, 0], w[:, 0])
    y = _group_norm(out.reshape(B, 1, d), p["ln_x"], cfg.rwkv_n_heads)
    return _out_proj(p, y * g), cache_lib.RWKV6State(shift_tm=x[:, 0, :], shift_cm=state.shift_cm, wkv=S_new)


def rwkv6_cmix_forward(p, cfg: ModelConfig, x, shift_state=None):
    B, S, d = x.shape
    prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device) if shift_state is None else shift_state[:, None, :]
    x_prev = torch.cat([prev, x[:, :-1]], dim=1)
    xx = x_prev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"]), x[:, -1, :]


def rwkv6_cmix_decode(p, cfg: ModelConfig, x, state: cache_lib.RWKV6State):
    y, last = rwkv6_cmix_forward(p, cfg, x, state.shift_cm)
    return y, cache_lib.RWKV6State(shift_tm=state.shift_tm, shift_cm=last, wkv=state.wkv)
