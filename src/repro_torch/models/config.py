"""Model configuration for the unified decoder family.

A copy of the JAX package's ``repro.models.config`` (the port imports
nothing of that package). One ModelConfig describes every architecture;
the layer stack is a list of homogeneous ``LayerGroup``s whose per-layer
parameters are stacked on a leading layer axis, the same layout the JAX
package uses, so weights bridge between the two without reshaping.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

BlockKind = Literal["attn", "mamba2", "rwkv6"]
MlpKind = Literal["dense", "moe", "rwkv_cmix", "none"]
AttnKind = Literal["gqa", "mla", "none"]
RopeKind = Literal["rope", "mrope", "none"]


@dataclass(frozen=True)
class LayerGroup:
    """A contiguous run of identical layers with stacked parameters."""

    kind: BlockKind
    mlp: MlpKind
    count: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # ---- attention features ----
    attn_kind: AttnKind = "gqa"
    causal: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_kind: RopeKind = "rope"
    rope_theta: float = 1_000_000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t, h, w (per half-dim)
    # ---- MLA (deepseek-v2) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    first_k_dense: int = 0           # leading dense layers (deepseek-v2: 1)
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    dense_d_ff: int = 0              # d_ff for the leading dense layers / shared experts scale
    # ---- SSM (mamba2) ----
    ssm_state_size: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # ---- RWKV6 ----
    rwkv_head_size: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    ssm_ngroups: int = 1             # B/C groups: head h reads group h // (n_heads / ngroups)
    # ---- hybrid (zamba2): shared attention block every N ssm layers ----
    shared_attn_every: int = 0
    shared_attn_lora_rank: int = 0   # per-invocation LoRA on shared qkv
    # ---- hybrid as published (Zamba2's modeling_zamba2): a shared block
    # runs on [stream; the token's embeddings] before the Mamba2 layer at
    # each of these depths, with an exact-GELU GeGLU MLP; its output goes
    # through that depth's linear into the layer's norm input only ----
    hybrid_layer_ids: tuple[int, ...] = ()
    n_shared_blocks: int = 1          # invocation i runs block i % n_shared_blocks
    shared_mlp_lora_rank: int = 0     # per-invocation adapter on the MLP's gate_up
    attn_scale: float | None = None   # softmax scale; None: 1/sqrt(d_head)
    # ---- misc ----
    block_kind: BlockKind = "attn"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_inputs: bool = True        # False for stubbed modality frontends (vlm/audio)
    max_position: int = 1 << 20
    # Runtime knobs (not architecture): may be overridden per-run.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save MXU outputs, skip recompute)
    moe_dispatch: str = "per_lane"  # per_lane (shardable sort) | global
    scan_layers: bool = True  # False: python-unrolled stacks (roofline probes)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        # a tuple however given (a configuration file's list), so the config hashes
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))
        ids = self.hybrid_layer_ids
        if list(ids) != sorted(set(ids)) or not all(0 <= i < self.n_layers for i in ids):
            raise ValueError(f"hybrid_layer_ids {ids}: distinct ascending depths below n_layers={self.n_layers}")
        assert self.n_kv_heads == 0 or self.n_heads % max(self.n_kv_heads, 1) == 0

    # ------------------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_shared_block(self) -> bool:
        return self.shared_attn_every > 0 or bool(self.hybrid_layer_ids)

    @property
    def is_attention_free(self) -> bool:
        return self.block_kind in ("mamba2", "rwkv6") and not self.has_shared_block

    @property
    def ssm_d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def n_shared_attn_invocations(self) -> int:
        if self.hybrid_layer_ids:
            return len(self.hybrid_layer_ids)
        if self.shared_attn_every <= 0:
            return 0
        return self.n_layers // self.shared_attn_every

    # ------------------------------------------------------------------
    def layer_groups(self) -> list[LayerGroup]:
        """Homogeneous scan groups, in depth order."""
        if self.block_kind == "rwkv6":
            return [LayerGroup("rwkv6", "rwkv_cmix", self.n_layers)]
        if self.block_kind == "mamba2":
            return [LayerGroup("mamba2", "none", self.n_layers)]
        mlp: MlpKind = "moe" if self.is_moe else "dense"
        groups: list[LayerGroup] = []
        if self.is_moe and self.first_k_dense > 0:
            groups.append(LayerGroup("attn", "dense", self.first_k_dense))
        groups.append(
            LayerGroup("attn", mlp, self.n_layers - (self.first_k_dense if self.is_moe else 0))
        )
        return groups

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (for rooflines and Table-1 style math)."""
        D, V = self.d_model, self.vocab_size
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += D * V  # lm head
        per_layer_attn = 0
        if self.block_kind == "attn":
            if self.attn_kind == "mla":
                qdim = self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                if self.q_lora_rank:
                    per_layer_attn += D * self.q_lora_rank + self.q_lora_rank * qdim
                else:
                    per_layer_attn += D * qdim
                per_layer_attn += D * (self.kv_lora_rank + self.qk_rope_head_dim)
                per_layer_attn += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.v_head_dim
                )
                per_layer_attn += self.n_heads * self.v_head_dim * D
            else:
                q = D * self.n_heads * self.d_head
                kv = 2 * D * self.n_kv_heads * self.d_head
                o = self.n_heads * self.d_head * D
                per_layer_attn = q + kv + o
        total_layers = 0
        for g in self.layer_groups():
            if g.kind == "attn":
                per_mlp = (
                    3 * D * (self.dense_d_ff or self.d_ff)
                    if g.mlp == "dense" and self.is_moe
                    else 3 * D * self.d_ff
                )
                if g.mlp == "moe":
                    per_mlp = self.n_experts * 3 * D * self.d_ff
                    per_mlp += self.n_experts * D  # router
                    per_mlp += self.n_shared_experts * 3 * D * (self.dense_d_ff or self.d_ff)
                total_layers += g.count * (per_layer_attn + per_mlp + 2 * D)
            elif g.kind == "mamba2":
                di, ds, nh = self.ssm_d_inner, self.ssm_state_size * self.ssm_ngroups, self.ssm_n_heads
                inp = D * (2 * di + 2 * ds + nh)
                conv = (di + 2 * ds) * self.ssm_conv_width
                out = di * D
                total_layers += g.count * (inp + conv + out + nh + nh + di + D)
            elif g.kind == "rwkv6":
                hs = self.rwkv_head_size
                tm = 4 * D * D + D * hs  # r,k,v,o(g) projections + per-head extras
                tm += 5 * (self.rwkv_lora_mix * D * 2) + self.rwkv_lora_decay * D * 2
                cm = 2 * D * self.d_ff
                total_layers += g.count * (tm + cm + 2 * D)
        total += total_layers
        if self.shared_attn_every > 0:
            q = D * self.n_heads * self.d_head
            kv = 2 * D * self.n_kv_heads * self.d_head
            o = self.n_heads * self.d_head * D
            mlp = 3 * D * self.d_ff
            total += q + kv + o + mlp + 2 * D
            r = self.shared_attn_lora_rank
            if r:
                qkv_out = (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                total += self.n_shared_attn_invocations * (D * r + r * qkv_out)
        if self.hybrid_layer_ids:
            a = 2 * D
            hd = self.n_heads * self.d_head
            kvd = self.n_kv_heads * self.d_head
            block = a + a * (hd + 2 * kvd) + hd * D + D + 3 * D * self.d_ff
            r = self.shared_mlp_lora_rank
            total += self.n_shared_blocks * block + self.n_shared_attn_invocations * (D * r + r * 2 * self.d_ff + D * D)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.n_layers - self.first_k_dense
        skipped = moe_layers * (self.n_experts - self.experts_per_token) * 3 * self.d_model * self.d_ff
        return full - skipped

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        small: dict = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            max_position=65536,
        )
        n_heads = max(2, min(self.n_heads, 4))
        small["n_heads"] = n_heads
        if self.n_kv_heads:
            small["n_kv_heads"] = n_heads if self.n_kv_heads == self.n_heads else max(1, n_heads // 2)
        small["d_head"] = small["d_model"] // n_heads
        if self.is_moe:
            small.update(
                n_experts=4,
                experts_per_token=2,
                n_shared_experts=min(self.n_shared_experts, 1),
                first_k_dense=min(self.first_k_dense, 1),
                dense_d_ff=min(self.dense_d_ff, 512) if self.dense_d_ff else 0,
            )
        if self.attn_kind == "mla":
            small.update(
                kv_lora_rank=64,
                q_lora_rank=32 if self.q_lora_rank else 0,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
                d_head=0,
            )
        if self.block_kind == "mamba2":
            small.update(ssm_state_size=min(self.ssm_state_size, 16), ssm_head_dim=32, ssm_chunk=32)
        if self.hybrid_layer_ids:
            # uneven depths, three invocations over alternating blocks, the
            # attention as wide as its [stream; embeddings] input
            small.update(n_layers=5, hybrid_layer_ids=(1, 2, 4), d_head=2 * small["d_model"] // n_heads,
                         shared_mlp_lora_rank=min(self.shared_mlp_lora_rank, 8))
        if self.block_kind == "rwkv6":
            small.update(rwkv_head_size=32, rwkv_lora_decay=16, rwkv_lora_mix=8)
        if self.rope_kind == "mrope":
            half = (small["d_model"] // n_heads) // 2
            t = half // 4
            h = (half - t) // 2
            small["mrope_sections"] = (t, h, half - t - h)
        if self.shared_attn_every:
            small.update(shared_attn_every=1, shared_attn_lora_rank=min(self.shared_attn_lora_rank, 8))
        small["name"] = self.name + "-smoke"
        small.update(overrides)
        return dataclasses.replace(self, **small)
