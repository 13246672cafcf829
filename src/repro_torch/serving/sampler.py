"""Token sampling: greedy / temperature / top-k / top-p.

Port of the JAX package's ``repro.serving.sampler``. Two entry points:

* :func:`sample` — one :class:`SamplingParams` for the whole batch;
* :func:`sample_lanes` — per-lane parameters stacked as device tensors
  (:class:`LaneSampling`), so a greedy river and exploratory side lanes
  share one sampling pass (the engine's tick and the BatchServer's step,
  whose stacked parameters a :class:`SampCache` keeps).
 Lanes with ``temperature <= 0`` take the exact
``argmax`` of their logits, independent of the generator and of every
other lane. Stochastic lanes draw from a device ``torch.Generator`` by the
Gumbel-max trick; the reference's JAX key chain cannot be replayed, so only
their support and their determinism under a fixed generator carry over.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import to_device
from repro_torch.kernels.ops import NEG_INF


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1 = disabled
    greedy: bool = False


@dataclass
class LaneSampling:
    """Per-lane sampling parameters stacked over the batch axis.
    ``temperature <= 0`` marks a greedy lane; ``top_k == 0`` / ``top_p == 1``
    disable those filters."""

    temperature: torch.Tensor  # [B] f32
    top_k: torch.Tensor        # [B] int32
    top_p: torch.Tensor        # [B] f32

    def set_lane(self, lane: int, temp: float, top_k: int, top_p: float):
        """In place: one lane's parameters (an admission-time update)."""
        self.temperature[lane] = temp
        self.top_k[lane] = top_k
        self.top_p[lane] = top_p


def lane_values(params: SamplingParams) -> tuple[float, int, float]:
    """(temperature, top_k, top_p) scalars for one lane."""
    t = 0.0 if (params.greedy or params.temperature <= 0.0) else params.temperature
    return float(t), int(params.top_k), float(params.top_p)


def lane_params(params: SamplingParams, n: int, *, device) -> LaneSampling:
    """Broadcast one SamplingParams to ``n`` lanes."""
    t, k, p = lane_values(params)
    return LaneSampling(
        temperature=torch.full((n,), t, dtype=torch.float32, device=device),
        top_k=torch.full((n,), k, dtype=torch.int32, device=device),
        top_p=torch.full((n,), p, dtype=torch.float32, device=device),
    )


def stack_lane_params(params_list, *, device) -> LaneSampling:
    """Stack a list of SamplingParams (one per lane) into a LaneSampling."""
    vals = [lane_values(p) for p in params_list]
    return LaneSampling(
        temperature=to_device([v[0] for v in vals], torch.float32, device),
        top_k=to_device([v[1] for v in vals], torch.int32, device),
        top_p=to_device([v[2] for v in vals], torch.float32, device),
    )


def cat_lanes(*parts: LaneSampling) -> LaneSampling:
    return LaneSampling(
        temperature=torch.cat([p.temperature for p in parts]),
        top_k=torch.cat([p.top_k for p in parts]),
        top_p=torch.cat([p.top_p for p in parts]),
    )


class SampCache:
    """Memoised (stacked LaneSampling, use_filters, any_greedy) for a lane
    composition, with an explicit invalidation hook.

    Serving loops rebuild the stacked per-lane tensors only when the lane
    composition changes. Admission, completion and mid-flight retirement
    must ALL call :meth:`invalidate`: a stale cache would hand a recycled
    lane the previous request's sampling parameters (and, through the fast
    path flags, could pin the whole batch to the wrong sampler branch)."""

    def __init__(self, device):
        self.device = device
        self._val = None

    @property
    def valid(self) -> bool:
        return self._val is not None

    def invalidate(self):
        self._val = None

    def get(self, lane_params):
        """``lane_params``: zero-argument callable returning the per-lane
        SamplingParams list; only consulted on a miss."""
        if self._val is None:
            ps = list(lane_params())
            self._val = (stack_lane_params(ps, device=self.device), *static_flags(ps))
        return self._val


def static_flags(params_iterable) -> tuple[bool, bool]:
    """(use_filters, any_greedy) over the given lanes' SamplingParams — the
    host-side switches that let :func:`sample_lanes` skip the sort when no
    lane filters and the argmax select when no lane is greedy."""
    ps = list(params_iterable)
    use_filters = any(p.top_k > 0 or p.top_p < 1.0 for p in ps)
    any_greedy = any(p.greedy or p.temperature <= 0.0 for p in ps)
    return use_filters, any_greedy


def _gumbel_argmax(gen: torch.Generator, logits):
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def sample(gen: torch.Generator, logits, params: SamplingParams):
    """logits [B, V] -> tokens [B] int32 under one SamplingParams; every
    branch is picked on the host from ``params``."""
    if params.greedy or params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if params.temperature != 1.0:
        logits = logits / max(params.temperature, 1e-6)
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, torch.full_like(logits, -torch.inf), logits)
    return _gumbel_argmax(gen, logits).to(torch.int32)


def sample_lanes(gen: torch.Generator, logits, lanes: LaneSampling, *, use_filters: bool = True,
                 any_greedy: bool = True):
    """logits: [B, V] -> tokens [B] int32, per-lane parameters as tensors.

    One descending sort serves both filters: rank < top_k, and cumulative
    probability before a token < top_p (the top token always survives). The
    finite NEG_INF keeps filtered rows NaN-free. Greedy lanes are the exact
    ``argmax`` of the raw logits (first index on ties). No device value is
    read on the host.
    """
    B, V = logits.shape
    temps = lanes.temperature.to(logits.dtype)
    # tiny positive temperatures clamp as in the reference (no inf overflow)
    safe_t = torch.where(temps > 0.0, torch.clamp(temps, min=1e-6), torch.ones_like(temps))
    scaled = logits / safe_t[:, None]
    if use_filters:
        ranked, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
        ranks = torch.arange(V, device=logits.device)[None, :]
        k = torch.where(lanes.top_k > 0, lanes.top_k, torch.full_like(lanes.top_k, V))[:, None]
        keep_k = ranks < k
        neg = torch.full_like(ranked, NEG_INF)
        # the nucleus is taken from the renormalised post-top-k distribution
        ranked_k = torch.where(keep_k, ranked, neg)
        probs = torch.softmax(ranked_k, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = keep_k & ((cum - probs) < lanes.top_p[:, None])
        keep[:, 0] = True
        choice = _gumbel_argmax(gen, torch.where(keep, ranked, neg))
        samp = torch.gather(order, 1, choice[:, None])[:, 0]
    else:
        samp = _gumbel_argmax(gen, scaled)
    if any_greedy:
        samp = torch.where(temps <= 0.0, torch.argmax(logits, dim=-1), samp)
    return samp.to(torch.int32)
