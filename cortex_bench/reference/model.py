"""Plain PyTorch reference of a dense GQA decoder, in float32.

Written from the architecture's equations, as a configuration file states
them, with no code of the program: pre-norm layers of grouped-query
attention (optional qkv bias, optional per-head RMSNorm of q and k before
RoPE, split-half RoPE) and a SwiGLU MLP, a final norm, a tied or separate
head (Qwen2.5, Qwen3). The weights are the benchmark's own tensors, read
in the program's parameter layout and converted here.

It judges only what it reads: a configuration that asks for a feature it
does not implement, or a weight tree with a leaf it does not read, is
refused (``Unsupported``). Another family brings its own reference module
beside this one, named by its configuration file's ``reference``.

``low=True`` is the control: every matmul operand is rounded to fp8
(e4m3, one scale per tensor) before an f32 product, the precision below
the configuration's bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale (its largest magnitude at
    the format's largest value), returned in f32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _tree(fn, t):
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(fn, v) for v in t]
    return fn(t)


# weight leaves that enter a matmul (rounded in the control)
_MATMUL = {"embed", "head", "wq", "wk", "wv", "wo", "gate", "up", "down"}

# the configuration's fields this reference implements, at the values it
# implements them; a field left out of a configuration takes the value here
SUPPORTED = {"arch_type": "dense", "attn_kind": "gqa", "block_kind": "attn", "rope_kind": "rope",
             "causal": True, "n_experts": 0, "shared_attn_every": 0, "embed_inputs": True}


class Unsupported(ValueError):
    """The configuration or its weights hold what this reference does not read."""


def leaves(t, path=""):
    """The leaf paths of a weight tree, a list's index left out."""
    if isinstance(t, dict):
        return {q for k, v in t.items() for q in leaves(v, f"{path}/{k}")}
    if isinstance(t, (list, tuple)):
        return {q for v in t for q in leaves(v, path)}
    return {path}


def read_leaves(arch: dict) -> set:
    """The weight leaves this reference reads for a configuration."""
    attn = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if arch.get("qkv_bias") else []) \
        + (["q_norm", "k_norm"] if arch.get("qk_norm") else [])
    layer = ["ln1", "ln2"] + [f"attn/{k}" for k in attn] + ["mlp/gate", "mlp/up", "mlp/down"]
    top = ["embed", "final_norm"] + ([] if arch.get("tie_embeddings") else ["head"])
    return {f"/{k}" for k in top} | {f"/groups/{k}" for k in layer}


class RefModel:
    """``arch``: the ``model`` block of a configuration file (the port's
    field names); ``params``: the weight tree."""

    def __init__(self, arch: dict, params, *, low: bool = False):
        bad = {k: arch[k] for k, v in SUPPORTED.items() if k in arch and arch[k] != v}
        if bad:
            raise Unsupported(f"the dense reference does not implement {bad}")
        if len(params["groups"]) != 1:
            raise Unsupported(f"{len(params['groups'])} layer groups; the dense reference reads one")
        got, want = leaves(params), read_leaves(arch)
        if got != want:
            raise Unsupported(f"weight leaves not read: {sorted(got - want)}; missing: {sorted(want - got)}")
        self.a = arch
        self.low = low
        self.H, self.Hkv, self.D = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
        self.eps = arch.get("norm_eps", 1e-6)
        self.theta = arch["rope_theta"]

        def walk(t, key=""):
            if isinstance(t, dict):
                return {k: walk(v, k) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [walk(v, key) for v in t]
            t = t.float()
            return fp8_round(t) if low and key in _MATMUL else t

        self.p = walk(params)
        self.dev = self.p["final_norm"].device
        self.inv_freq = torch.from_numpy(
            1.0 / (self.theta ** (np.arange(0, self.D, 2).astype(np.float32) / self.D))).to(self.dev)

    # -- primitives ---------------------------------------------------
    def mm(self, x, w):
        if self.low:
            x = fp8_round(x)
        return x @ w

    def rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * w

    def rope(self, x, pos):
        """x [..., S, h, D]; pos [..., S] (int)."""
        ang = pos.float()[..., None] * self.inv_freq
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def mlp(self, p, x):
        return self.mm(F.silu(self.mm(x, p["gate"])) * self.mm(x, p["up"]), p["down"])

    def head(self, x):
        w = self.p["embed"].T if "head" not in self.p else self.p["head"]
        return self.mm(x, w)

    def embed(self, tok):
        return self.p["embed"][tok.long()]

    def qkv(self, p, x):
        """x [..., d] -> q [..., H, D], k, v [..., Hkv, D] (unrotated; q and
        k normed per head where the configuration says so)."""
        H, Hkv, D = self.H, self.Hkv, self.D
        q, k, v = self.mm(x, p["wq"]), self.mm(x, p["wk"]), self.mm(x, p["wv"])
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        sh = x.shape[:-1]
        q, k, v = q.reshape(*sh, H, D), k.reshape(*sh, Hkv, D), v.reshape(*sh, Hkv, D)
        if "q_norm" in p:
            q, k = self.rms(q, p["q_norm"]), self.rms(k, p["k_norm"])
        return q, k, v

    def attend(self, q, k, v, valid):
        """q [B, H, D]; k, v [B, T, Hkv, D]; valid [B, T] -> (out [B, H, D],
        mass [B, T]: softmax mass summed over the heads)."""
        B, H, D = q.shape
        G = H // k.shape[2]
        s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, -1, G, D), k) / math.sqrt(D)
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", p, v).reshape(B, H, D)
        return out, p.sum(dim=(1, 2))

    def causal_attention(self, q, k, v):
        """[B, S, H, D] x [B, S, Hkv, D] causal -> [B, S, H, D], in blocks of
        queries."""
        B, S, H, D = q.shape
        G = H // k.shape[2]
        qg = q.reshape(B, S, -1, G, D)
        out = []
        for c0 in range(0, S, 512):
            qc = qg[:, c0:c0 + 512]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, k) / math.sqrt(D)
            m = torch.arange(S, device=q.device)[None, :] <= (c0 + torch.arange(qc.shape[1], device=q.device))[:, None]
            s = torch.where(m, s, torch.full_like(s, NEG))
            out.append(torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, dim=-1), v))
        return torch.cat(out, dim=1).reshape(B, S, H, D)

    def _layer(self, i):
        return {k: _tree(lambda t: t[i], v) for k, v in self.p["groups"][0].items()}

    # -- whole sequences (prompts, thoughts) ------------------------------
    def prefill(self, tok, pos):
        """tok, pos [B, S]. Returns (final hidden [B, S, d] after the norm,
        rotated keys and values of each layer [B, S, Hkv, D], the recurrent
        states: none in this family)."""
        x = self.embed(tok)
        kv = []
        for i in range(self.a["n_layers"]):
            p = self._layer(i)
            q, k, v = self.qkv(p["attn"], self.rms(x, p["ln1"]))
            q, k = self.rope(q, pos), self.rope(k, pos)
            kv.append((k, v))
            x = x + self.mm(self.causal_attention(q, k, v).flatten(-2), p["attn"]["wo"])
            x = x + self.mlp(p["mlp"], self.rms(x, p["ln2"]))
        return self.rms(x, self.p["final_norm"]), kv, []

    # -- one token --------------------------------------------------------
    def step(self, tok, pos, mems, states):
        """tok, pos [B]; ``mems``: one memory per layer (its
        ``step(q, k, v, pos)`` inserts the new key and attends); ``states``:
        the recurrent states (none here). Returns (logits [B, V], final
        hidden [B, d])."""
        x = self.embed(tok)
        for i in range(self.a["n_layers"]):
            p = self._layer(i)
            q, k, v = self.qkv(p["attn"], self.rms(x, p["ln1"]))
            q, k = self.rope(q[:, None], pos[:, None])[:, 0], self.rope(k[:, None], pos[:, None])[:, 0]
            x = x + self.mm(mems[i].step(self, q, k, v, pos).flatten(-2), p["attn"]["wo"])
            x = x + self.mlp(p["mlp"], self.rms(x, p["ln2"]))
        hid = self.rms(x, self.p["final_norm"])
        return self.head(hid), hid
