"""Plain PyTorch reference of Zamba2 as published, in float32.

Written from the equations of ``transformers``' ``modeling_zamba2``
(``Zamba2MambaDecoderLayer``, ``Zamba2MambaMixer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``, ``Zamba2RMSNormGated``,
``Zamba2HybridLayer``, ``Zamba2Model.get_layers``), with no code of the
program and no kernel:

* every depth is a Mamba2 layer: ``x + mamba(norm(x + t))``, where ``t``
  is the output of the shared block invoked before that depth (zero at
  the other depths); the stream itself never takes ``t``;
* the mixer: in-projection to [z; x B C; dt], a causal depthwise conv
  and SiLU over [x B C], B and C in groups (head h reads group
  h // (heads / groups)), dt = softplus(dt + dt_bias), the selective scan
  H_t = exp(dt_t A) H_{t-1} + dt_t x_t B_t^T, y_t = H_t C_t + D x_t, then
  RMSNorm of y * silu(z) over each group's channels and the out-projection;
* invocation i (before depth ``hybrid_layer_ids[i]``) runs block
  i mod ``n_shared_blocks`` on [stream; the token's embeddings]: RMSNorm,
  multi-head attention with split-half RoPE over the whole head and the
  configured scale, RMSNorm, a gated MLP act(gate) * up with exact GELU and
  the invocation's rank-r adapter added to [gate; up] before the split,
  no residual; then the invocation's linear;
* a final RMSNorm and the tied head.

The scan runs over blocks of ``SCAN_BLOCK`` tokens (the last one as short
as the sequence leaves it) in its quadratic within-block form. One
departure from ``transformers``: its plain-PyTorch mixer clamps dt below
at ``time_step_min``; its kernel path, which the published config's
``time_step_limit`` of null selects, does not, and neither does this file.

Weights are the benchmark's own tensors in the program's layout, read as
they are and converted to f32 where a layer uses them, so no whole f32
copy is held beside them. ``low=True`` is the control: every matmul
operand rounded to fp8 (e4m3, one scale per tensor) before an f32 product.
It judges only what it reads: a configuration or a weight tree outside
this architecture is refused (``Unsupported``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cortex_bench.reference.model import Unsupported, fp8_round, leaves

NEG = -1e30
SCAN_BLOCK = 64

# the configuration's fields this reference implements, at the values it
# implements them; a field left out of a configuration takes the value here
SUPPORTED = {"arch_type": "hybrid", "block_kind": "mamba2", "attn_kind": "gqa", "rope_kind": "rope",
             "causal": True, "n_experts": 0, "shared_attn_every": 0, "shared_attn_lora_rank": 0,
             "embed_inputs": True, "qkv_bias": False, "qk_norm": False, "tie_embeddings": True}
REQUIRED = ("hybrid_layer_ids", "n_shared_blocks", "attn_scale", "shared_mlp_lora_rank", "ssm_ngroups")

_MIXER = ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "gate_norm", "w_out")


def read_leaves() -> set:
    """The weight leaves this reference reads."""
    block = ["ln1", "ln2", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/gate", "mlp/up", "mlp/down"]
    inv = ["w_out", "lora_a", "lora_b"]
    return ({"/embed", "/final_norm", "/groups/ln"} | {f"/groups/mixer/{k}" for k in _MIXER}
            | {f"/shared_attn/{k}" for k in block} | {f"/hybrid/{k}" for k in inv})


def _at(t, i):
    return {k: _at(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]


class RefModel:
    """``arch``: the ``model`` block of a configuration file (the port's
    field names); ``params``: the weight tree."""

    def __init__(self, arch: dict, params, *, low: bool = False):
        bad = {k: arch.get(k, v) for k, v in SUPPORTED.items() if arch.get(k, v) != v}
        missing = [k for k in REQUIRED if not arch.get(k)]
        if bad or missing:
            raise Unsupported(f"the Zamba2 reference does not implement {bad}; needs {missing}")
        if len(params["groups"]) != 1:
            raise Unsupported(f"{len(params['groups'])} layer groups; the Zamba2 reference reads one")
        got, want = leaves(params), read_leaves()
        if got != want:
            raise Unsupported(f"weight leaves not read: {sorted(got - want)}; missing: {sorted(want - got)}")
        self.a, self.low, self.p = arch, low, params
        self.L, self.d = arch["n_layers"], arch["d_model"]
        self.H, self.Hkv, self.D = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
        self.scale = arch["attn_scale"]
        self.ids = list(arch["hybrid_layer_ids"])
        self.nb = arch["n_shared_blocks"]
        self.eps = arch.get("norm_eps", 1e-6)
        self.di = arch.get("ssm_expand", 2) * self.d
        self.dh, self.ds, self.G = arch.get("ssm_head_dim", 64), arch["ssm_state_size"], arch["ssm_ngroups"]
        self.nh, self.W = self.di // self.dh, arch.get("ssm_conv_width", 4)
        self.dev = params["final_norm"].device
        self.embed = self.w(params["embed"])  # the table and the tied head
        theta = arch["rope_theta"]
        self.inv_freq = torch.from_numpy(
            1.0 / (theta ** (np.arange(0, self.D, 2).astype(np.float32) / self.D))).to(self.dev)

    # -- primitives -----------------------------------------------------
    def w(self, t):
        """A matmul weight in f32 (fp8-rounded in the control)."""
        t = t.float()
        return fp8_round(t) if self.low else t

    def mm(self, x, w):
        if self.low:
            x = fp8_round(x)
        return x @ self.w(w)

    def rms(self, x, w, groups: int = 1):
        x = x.unflatten(-1, (groups, -1))
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return x.flatten(-2) * w.float()

    def rope(self, x, pos):
        """x [..., S, h, D]; pos [..., S] (int)."""
        ang = pos.float()[..., None] * self.inv_freq
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def head(self, x):
        return (fp8_round(x) if self.low else x) @ self.embed.T

    def attend(self, q, k, v, valid):
        """q [B, H, D]; k, v [B, T, Hkv, D]; valid [B, T] -> (out [B, H, D],
        mass [B, T]: softmax mass summed over the heads), at the model's scale."""
        B, H, D = q.shape
        G = H // k.shape[2]
        s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, -1, G, D), k) * self.scale
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgt,btkd->bkgd", p, v).reshape(B, H, D), p.sum(dim=(1, 2))

    def causal_attention(self, q, k, v):
        """[B, S, H, D] x [B, S, Hkv, D] causal -> [B, S, H, D], in blocks of queries."""
        B, S, H, D = q.shape
        G = H // k.shape[2]
        qg = q.reshape(B, S, -1, G, D)
        out = []
        for c0 in range(0, S, 512):
            qc = qg[:, c0:c0 + 512]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, k) * self.scale
            m = torch.arange(S, device=q.device)[None, :] <= (c0 + torch.arange(qc.shape[1], device=q.device))[:, None]
            s = torch.where(m, s, torch.full_like(s, NEG))
            out.append(torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, dim=-1), v))
        return torch.cat(out, dim=1).reshape(B, S, H, D)

    # -- the shared block -------------------------------------------------
    def _qkv(self, inv: int, x, emb):
        """Invocation ``inv``'s block input [stream; embeddings], normed,
        projected: q [..., H, D], k, v [..., Hkv, D] (unrotated)."""
        bp = _at(self.p["shared_attn"], inv % self.nb)
        h = self.rms(torch.cat([x, emb], dim=-1), bp["ln1"])
        sh = h.shape[:-1]
        q = self.mm(h, bp["attn"]["wq"]).reshape(*sh, self.H, self.D)
        k = self.mm(h, bp["attn"]["wk"]).reshape(*sh, self.Hkv, self.D)
        v = self.mm(h, bp["attn"]["wv"]).reshape(*sh, self.Hkv, self.D)
        return q, k, v

    def _block_out(self, inv: int, o):
        """The block's attention output o [..., H, D] through o-proj, its
        MLP (no residual) and the invocation's linear."""
        bp, ip = _at(self.p["shared_attn"], inv % self.nb), _at(self.p["hybrid"], inv)
        h = self.rms(self.mm(o.flatten(-2), bp["attn"]["wo"]), bp["ln2"])
        gate, up = self.mm(h, bp["mlp"]["gate"]), self.mm(h, bp["mlp"]["up"])
        if "lora_a" in ip:
            delta = self.mm(self.mm(h, ip["lora_a"]), ip["lora_b"])
            ff = gate.shape[-1]
            gate, up = gate + delta[..., :ff], up + delta[..., ff:]
        y = self.mm(F.gelu(gate) * up, bp["mlp"]["down"])
        return self.mm(y, ip["w_out"])

    # -- the Mamba2 mixer ---------------------------------------------------
    def _split(self, p, h):
        """(z, x B C before the conv, dt) of the in-projection."""
        zx = self.mm(h, p["w_in"])
        di, c = self.di, self.di + 2 * self.G * self.ds
        return zx[..., :di], zx[..., di:di + c], zx[..., di + c:]

    def _ssm_in(self, p, u, dt):
        """From the conv's output u [..., conv channels]: x [..., nh, dh],
        B and C per head [..., nh, ds], dt [..., nh] after softplus."""
        di, gs = self.di, self.G * self.ds
        rep = lambda t: torch.repeat_interleave(t.unflatten(-1, (self.G, self.ds)), self.nh // self.G, dim=-2)
        xs = u[..., :di].unflatten(-1, (self.nh, self.dh))
        return xs, rep(u[..., di:di + gs]), rep(u[..., di + gs:]), F.softplus(dt + p["dt_bias"].float())

    def _mixer_out(self, p, y, xs, z):
        y = y + p["d_skip"].float()[:, None] * xs
        y = self.rms(y.flatten(-2) * F.silu(z), p["gate_norm"], self.G)
        return self.mm(y, p["w_out"])

    def mamba_seq(self, p, h):
        """h [B, S, d] -> (out [B, S, d], [conv tail [B, W-1, ch], state [B, nh, dh, ds]])."""
        B, S, _ = h.shape
        z, xbc, dt = self._split(p, h)
        xpad = F.pad(xbc, (0, 0, self.W - 1, 0))
        cw = p["conv_w"].float()
        u = F.silu(sum(xpad[:, i:i + S] * cw[i] for i in range(self.W)) + p["conv_b"].float())
        xs, Bh, Ch, dt = self._ssm_in(p, u, dt)
        A = -torch.exp(p["a_log"].float())
        state = torch.zeros(B, self.nh, self.dh, self.ds, device=h.device)
        ys = []
        for c0 in range(0, S, SCAN_BLOCK):
            sl = slice(c0, c0 + SCAN_BLOCK)
            cum = torch.cumsum(dt[:, sl] * A, dim=1)                   # [B, T, nh]
            T = cum.shape[1]
            causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()[None, :, :, None]
            seg = cum[:, :, None, :] - cum[:, None, :, :]              # [B, t, j, nh]
            decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, -torch.inf)))
            xdt = xs[:, sl] * dt[:, sl, :, None]                       # [B, T, nh, dh]
            cb = torch.einsum("bthn,bjhn->btjh", Ch[:, sl], Bh[:, sl])
            y = torch.einsum("btjh,bjhd->bthd", cb * decay, xdt)
            y = y + torch.einsum("bthn,bhdn->bthd", Ch[:, sl], state) * torch.exp(cum)[..., None]
            ys.append(y)
            last = torch.exp(cum[:, -1:] - cum)                        # [B, T, nh]
            state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                     + torch.einsum("bjh,bjhn,bjhd->bhdn", last, Bh[:, sl], xdt))
        out = self._mixer_out(p, torch.cat(ys, dim=1), xs, z)
        return out, [xpad[:, S:], state]

    def mamba_step(self, p, h, st):
        """h [B, d]; st [conv tail, state], replaced by the new ones -> out [B, d]."""
        z, xbc, dt = self._split(p, h)
        window = torch.cat([st[0], xbc[:, None]], dim=1)               # [B, W, ch]
        u = F.silu((window * p["conv_w"].float()).sum(1) + p["conv_b"].float())
        xs, Bh, Ch, dt = self._ssm_in(p, u, dt)
        a = torch.exp(dt * -torch.exp(p["a_log"].float()))
        state = st[1] * a[..., None, None] + torch.einsum("bhd,bhn->bhdn", xs * dt[..., None], Bh)
        st[0], st[1] = window[:, 1:], state
        return self._mixer_out(p, torch.einsum("bhdn,bhn->bhd", state, Ch), xs, z)

    def _layer(self, i):
        return _at(self.p["groups"][0], i)

    # -- whole sequences (prompts, thoughts) ------------------------------
    def prefill(self, tok, pos):
        """tok, pos [B, S]. Returns (final hidden [B, S, d] after the norm,
        each invocation's rotated keys and values [B, S, Hkv, D], each
        layer's recurrent state [conv tail, SSM state])."""
        x = emb = self.embed[tok.long()]
        kv, states, extra = [], [], 0.0
        for i in range(self.L):
            if i in self.ids:
                inv = self.ids.index(i)
                q, k, v = self._qkv(inv, x, emb)
                q, k = self.rope(q, pos), self.rope(k, pos)
                kv.append((k, v))
                extra = self._block_out(inv, self.causal_attention(q, k, v))
            p = self._layer(i)
            y, st = self.mamba_seq(p["mixer"], self.rms(x + extra, p["ln"]))
            states.append(st)
            x, extra = x + y, 0.0
        return self.rms(x, self.p["final_norm"]), kv, states

    # -- one token --------------------------------------------------------
    def step(self, tok, pos, mems, states):
        """tok, pos [B]; ``mems``: one memory per invocation (its
        ``step(m, q, k, v, pos)`` inserts the new key and attends);
        ``states``: each layer's [conv tail, SSM state], updated. Returns
        (logits [B, V], final hidden [B, d])."""
        x = emb = self.embed[tok.long()]
        extra = 0.0
        for i in range(self.L):
            if i in self.ids:
                inv = self.ids.index(i)
                q, k, v = self._qkv(inv, x, emb)
                q, k = self.rope(q[:, None], pos[:, None])[:, 0], self.rope(k[:, None], pos[:, None])[:, 0]
                extra = self._block_out(inv, mems[inv].step(self, q, k, v, pos))
            p = self._layer(i)
            x = x + self.mamba_step(p["mixer"], self.rms(x + extra, p["ln"]), states[i])
            extra = 0.0
        hid = self.rms(x, self.p["final_norm"])
        return self.head(hid), hid
