"""Mamba2 (SSD) mixer: the chunked parallel form and the O(1) decode step.

Port of the JAX package's ``repro.models.mamba2`` (zamba2's backbone).
The chunked state-space-dual algorithm writes the selective scan as
blocked matmuls: a within-chunk quadratic, attention-like term plus a
recurrence over chunk states. Plain PyTorch, as the reference is plain jnp
(its oracle is :func:`repro_torch.kernels.ref.mamba2_chunk_ref`).

Recurrence (per head h, scalar decay; B and C of the head's group,
``ssm_ngroups`` of them, heads split evenly):
    H_t = a_t * H_{t-1} + (dt_t x_t) ⊗ B_t        a_t = exp(dt_t * A_h)
    y_t = C_t · H_t + D_h * x_t
then RMSNorm of y * silu(z) over each group's channels.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba2_step
from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, lane_head_placements, per_shard, rms_norm, split_mesh


def mamba2_init(gen, cfg: ModelConfig, dtype, device, *, lead=()):
    dm, di, ds, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state_size * cfg.ssm_ngroups, cfg.ssm_n_heads
    d_conv_ch = di + 2 * ds
    f32 = lambda fill, n: torch.full((*lead, n), fill, dtype=torch.float32, device=device)
    conv_w = torch.randn((*lead, cfg.ssm_conv_width, d_conv_ch), generator=gen, device=device) * 0.1
    return {
        # in_proj -> [z (di), xBC (di + 2 ngroups ds), dt (nh)]
        "w_in": dense_init(gen, dm, 2 * di + 2 * ds + nh, dtype, device, lead=lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, d_conv_ch), dtype=dtype, device=device),
        "a_log": f32(0.0, nh),      # A = -exp(a_log) = -1
        "dt_bias": f32(0.0, nh),
        "d_skip": f32(1.0, nh),
        "gate_norm": torch.ones((*lead, di), dtype=dtype, device=device),
        "w_out": dense_init(gen, di, dm, dtype, device, lead=lead),
    }


def _split_in(cfg: ModelConfig, zxbcdt):
    di, ds = cfg.ssm_d_inner, cfg.ssm_state_size * cfg.ssm_ngroups
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ds], zxbcdt[..., 2 * di + 2 * ds:]


def _gated_norm(cfg: ModelConfig, y, z, weight):
    """RMSNorm of y * silu(z) over each group's own channels (one group:
    over all of d_inner)."""
    G = cfg.ssm_ngroups
    h = (y * F.silu(z)).unflatten(-1, (G, -1))
    return rms_norm(h, weight.unflatten(-1, (G, -1)), cfg.norm_eps).flatten(-2)


_SHARED = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "gate_norm")


def _on_lanes(core, p, *lane_args):
    """``core(*lane_args, *the mixer's small params)``; on a mesh, on each
    rank's block of lanes (over the data axes; channels and heads whole):
    every lane's scan is its own. The small params are shared by every
    lane, so each is expanded to one copy a lane before the split and the
    core reads copy 0: their gradients then sum over every rank's lanes."""
    shared = [p[n] for n in _SHARED]
    mesh = split_mesh(lane_args[0])
    if mesh is None:
        return core(*lane_args, *shared, per_lane=False)
    B = lane_args[0].shape[0]
    _, (lanes,) = lane_head_placements(lane_args[0], None, (None,))
    shared = [t[None].expand(B, *t.shape) for t in shared]
    args = (*lane_args, *shared)
    return per_shard(functools.partial(core, per_lane=True), mesh, (lanes,) * 3, (lanes,) * len(args), *args)


def mamba2_forward(p, cfg: ModelConfig, x, return_state: bool = False):
    """Full-sequence chunked SSD. x: [B,S,dm] -> y [B,S,dm] (and the
    terminal decode state). A sequence longer than a chunk and not a
    multiple of it has its last chunk padded with zeros, which leave the
    state as it was at the last real token."""
    y, conv_tail, carry = _on_lanes(functools.partial(_forward_core, cfg=cfg), p, x @ p["w_in"])
    out = y @ p["w_out"]
    if not return_state:
        return out
    return out, cache_lib.Mamba2State(conv=conv_tail.to(x.dtype), ssm=carry)


def _forward_core(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm, *, cfg: ModelConfig,
                  per_lane: bool):
    """Conv, SSD and gate of the in-projected [B,S,*]: (y [B,S,di] before
    the out-projection, the raw input tail, the final SSD state). With
    ``per_lane`` every param carries a leading lane dim (copy 0 is read)."""
    if per_lane:
        conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm = (
            t[0] for t in (conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm))
    B, S, _ = zxbcdt.shape
    di, ds, nh, dh, G = cfg.ssm_d_inner, cfg.ssm_state_size, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_ngroups
    Q = min(cfg.ssm_chunk, S)
    pad = -S % Q
    Sp = S + pad
    nC = Sp // Q
    hg = nh // G  # heads per group
    dev = zxbcdt.device

    z, xbc_raw, dt = _split_in(cfg, zxbcdt)
    # causal depthwise conv (width W)
    W = cfg.ssm_conv_width
    padded = F.pad(xbc_raw, (0, 0, W - 1, 0))
    conv = sum(padded[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(W)) + conv_b
    xbc = F.silu(conv)
    xs = xbc[..., :di].reshape(B, S, nh, dh)
    Bm = xbc[..., di:di + G * ds]   # [B,S,G*ds]
    Cm = xbc[..., di + G * ds:]     # [B,S,G*ds]

    dt = F.softplus(dt.float() + dt_bias)                       # [B,S,nh]
    A = -torch.exp(a_log)                                       # [nh]
    # the padded steps (zeros: decay 1, no input) leave the state as it was
    tail = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    la = tail(dt * A).reshape(B, nC, Q, G, hg)                  # log decay per step
    cum = torch.cumsum(la, dim=2)                               # Λ_i
    X = tail(xs.float() * dt[..., None]).reshape(B, nC, Q, G, hg, dh)
    Bc = tail(Bm.float()).reshape(B, nC, Q, G, ds)
    Cc = tail(Cm.float()).reshape(B, nC, Q, G, ds)

    # ---- intra-chunk: Y[i] = Σ_{j<=i} exp(Λ_i-Λ_j) (C_i·B_j) X_j ----
    Gm = torch.einsum("bcigs,bcjgs->bcijg", Cc, Bc)             # [B,nC,Q,Q,G]
    dec = cum[:, :, :, None] - cum[:, :, None, :]               # Λ_i - Λ_j: [B,nC,Q,Q,G,hg]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))[None, None, :, :, None, None]
    # above the diagonal Λ_i - Λ_j > 0 can overflow exp; its gradient would
    # be 0 x inf = NaN there, so the masked entries are zeroed before exp
    # too (the values are the reference's)
    zero = torch.zeros((), device=dev)
    M = torch.where(mask, torch.exp(torch.where(mask, dec, zero)), zero) * Gm[..., None]
    y_intra = torch.einsum("bcijgh,bcjghd->bcighd", M, X)

    # ---- chunk states: S_c = Σ_j exp(Λ_Q - Λ_j) B_j ⊗ X_j ----
    tail_dec = torch.exp(cum[:, :, -1:] - cum)                  # [B,nC,Q,G,hg]
    chunk_state = torch.einsum("bcjgh,bcjgs,bcjghd->bcghds", tail_dec, Bc, X)  # [B,nC,G,hg,dh,ds]
    chunk_decay = torch.exp(cum[:, :, -1])                      # [B,nC,G,hg]

    # ---- inter-chunk recurrence over chunk states ----
    carry = torch.zeros((B, G, hg, dh, ds), dtype=torch.float32, device=dev)
    prev = []
    for c in range(nC):
        prev.append(carry)  # the state entering chunk c
        carry = carry * chunk_decay[:, c, :, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                      # [B,nC,G,hg,dh,ds]
    y_inter = torch.einsum("bcigs,bcigh,bcghds->bcighd", Cc, torch.exp(cum), prev_states)

    y = (y_intra + y_inter).reshape(B, Sp, nh, dh)[:, :S] + xs.float() * d_skip[None, None, :, None]
    y = _gated_norm(cfg, y.reshape(B, S, di).to(zxbcdt.dtype), z, gate_norm)
    # terminal decode state: the raw (pre-conv) input's last W - 1 rows,
    # zeros before the first token when S < W - 1
    conv_tail = padded[:, S:, :]
    carry = carry.reshape(B, nh, dh, ds)
    return y, conv_tail, carry


# the steps ``mamba2_decode`` issued in this process, each layer of each
# decode batch once (the engine's ``mamba_steps`` is its change over a dispatch)
decode_steps = 0


def mamba2_decode(p, cfg: ModelConfig, x, state: cache_lib.Mamba2State):
    """Single-token step. x: [B,1,dm]. Returns (y [B,1,dm], new state).
    On the card the step writes ``state``'s own tensors and returns
    ``state`` itself (the reference is pure; the port updates in place so
    that the SSD state is read and written once a step)."""
    global decode_steps
    decode_steps += 1
    y, conv, ssm = _on_lanes(functools.partial(_decode_core, cfg=cfg), p, x[:, 0] @ p["w_in"], state.conv,
                             state.ssm)
    new = state if conv is state.conv and ssm is state.ssm else cache_lib.Mamba2State(conv=conv, ssm=ssm)
    return (y @ p["w_out"])[:, None, :], new


def _decode_core(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm, *,
                 cfg: ModelConfig, per_lane: bool):
    """One token of conv, SSD and gate: (y [B,di] before the
    out-projection, the new conv tail, the new SSD state). A CUDA tensor
    takes the hand-written step (:mod:`repro_torch.kernels.mamba2_step`),
    which writes the new tail and state into ``conv_state`` and
    ``ssm_state`` and returns them; any other the plain version."""
    if per_lane:
        conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm = (
            t[0] for t in (conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm))
    if zxbcdt.is_cuda:
        y = mamba2_step.mamba2_step(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm,
                                    eps=cfg.norm_eps)
        return y, conv_state, ssm_state
    return decode_plain(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm, cfg=cfg)


def decode_plain(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm, *,
                 cfg: ModelConfig):
    """The plain step on any device: what the kernel computes, with new
    tensors for the tail and the state (the inputs are left as they were)."""
    B = zxbcdt.shape[0]
    di, ds, nh, dh, G = cfg.ssm_d_inner, cfg.ssm_state_size, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_ngroups
    z, xbc, dt = _split_in(cfg, zxbcdt)
    # conv over [tail, new]
    window = torch.cat([conv_state, xbc[:, None, :].to(conv_state.dtype)], dim=1)  # [B, W, ch]
    conv = torch.einsum("bwc,wc->bc", window.float(), conv_w.float()) + conv_b.float()
    xbc_a = F.silu(conv)
    xs = xbc_a[:, :di].reshape(B, nh, dh)
    Bm = xbc_a[:, di:di + G * ds].reshape(B, G, ds)
    Cm = xbc_a[:, di + G * ds:].reshape(B, G, ds)
    dt = F.softplus(dt.float() + dt_bias)                       # [B,nh]
    a = torch.exp(dt * (-torch.exp(a_log)))                     # [B,nh]
    X = (xs * dt[..., None]).reshape(B, G, nh // G, dh)         # [B,G,hg,dh]
    upd = torch.einsum("bghd,bgs->bghds", X, Bm).reshape(B, nh, dh, ds)
    new_ssm = ssm_state * a[:, :, None, None] + upd
    y = torch.einsum("bghds,bgs->bghd", new_ssm.reshape(B, G, nh // G, dh, ds), Cm).reshape(B, nh, dh)
    y = y + xs * d_skip[None, :, None]
    y = _gated_norm(cfg, y.reshape(B, di).to(zxbcdt.dtype), z, gate_norm)
    return y, window[:, 1:, :], new_ssm
