"""Single-token decode attention over a synapse token set: the CUDA kernel
``csrc/synapse_attention.cu`` and its wrapper.

The per-tick hot loop of every side agent: one query per head against the
concatenated [landmarks; window; inject] key set, returning the attention
output and the per-key attention mass summed over heads (the paper's
density statistic). A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.synapse_attention_ref`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import CudaKernel, align16, ticket_counters
from repro_torch.kernels.ref import synapse_attention_ref

MAX_SMEM = 232_448   # bytes of shared memory a block may use on sm_90
SMEM_PER_SM = 233_472  # of which each resident block also takes 1 KB
THREADS = 256
MAX_CLUSTER = 16     # ranges per (lane, kv head): one cluster, non-portable above 8
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # the cluster sizes a plan may take, and ``resident_ctas`` reads
MIN_KEYS = 32        # keys a range keeps at least, where T allows
TWO_PER_SM = SMEM_PER_SM // 2 - 1024  # shared memory a CTA may take with another beside it
KV_SLOTS_BYTES = 16384  # the kv heads share a cluster where their mass slots of a range fit in this
STAGE_BYTES = 32768  # bytes of K or V one ring stage holds, about
MAX_STAGES = 8
MAX_SLICES = 8       # key slices of the f32 p.V, summed in order at the end
UPW = 4              # bf16 p.V: (16 d x 8 g) accumulator tiles a warp holds at most
BAR_BYTES = 128      # the mbarriers and the ticket flag
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "synapse_attention", "synapse_attention_launch",
    [_P] * 8 + [_I] * 13 + [ctypes.c_float, _I, _P],
)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one launch: a grid of (cluster, Hkv, B) CTAs of
    ``THREADS`` threads, one per (key range, kv head, lane); a cluster is
    the ``cluster`` ranges of ``kv_cluster`` kv heads (1, or all Hkv) of a
    lane. CTA r owns the keys ``ranges[r]`` of its kv head; its K and V
    pass through a ring of ``stages`` stages of ``chunk_keys`` keys (one
    tensor-map tile each), each key ``stage_row`` bytes, ``n_chunks``
    chunks a pass; its G x n_max f32 scores stay in shared memory, rows
    ``score_pitch`` floats apart; p.V splits the keys into
    ``slices``; ``smem`` bytes of dynamic shared memory per CTA. The mass
    over kv heads is summed in the cluster's shared memory where
    ``kv_cluster`` > 1; else, with ``mass_parts`` (Hkv > 1), through a
    [B, Hkv, T] f32 workspace and a [B, cluster] int32 ticket counter."""

    cluster: int
    kv_cluster: int
    ranges: tuple[tuple[int, int], ...]
    n_max: int
    chunk_keys: int
    n_chunks: int
    stages: int
    stage_row: int
    score_pitch: int
    slices: int
    smem: int
    grid: tuple[int, int, int]
    mass_parts: bool
    threads: int = THREADS

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, T: int, H: int, Hkv: int, D: int, elem_bytes: int, resident: tuple[int, ...], *,
                stage_bytes: int = STAGE_BYTES, max_cluster: int = MAX_CLUSTER) -> LaunchPlan:
    """The launch geometry for q [B,H,D] and keys/values [B,T,Hkv,D] of
    ``elem_bytes`` per value (2: bf16 on tensor cores; 4: f32) on a card
    that holds ``resident[i]`` CTAs at once, two an SM, in clusters of
    ``CLUSTER_SIZES[i]`` (:func:`resident_ctas` reads them); the kernel
    carves its shared memory by the same sums (``smem_bytes`` in the
    source) and refuses a plan that disagrees.

    The ranges per (lane, kv head): the most, a power of two up to
    ``max_cluster`` and at most T // ``MIN_KEYS``, whose grid the card holds
    in one wave; more, at the cost of a second wave, where a range's scores
    and ring would not fit in shared memory. Then as many ring stages of
    about ``stage_bytes`` (up to ``MAX_STAGES``) as the shared memory leaves
    room for, with a second CTA on the SM where the grid needs it. The kv
    heads of a lane join the cluster where C x Hkv is a cluster the card
    holds in one wave too and their mass slots of a range take at most
    ``KV_SLOTS_BYTES``.

    Raises ValueError naming the reason where the kernel cannot take the
    shape: a kv head's key row whose bytes are not a multiple of 16 (the
    bulk and tensor-map copies need it), more f32 columns than one
    tensor-map box takes, a bf16 head width that is not a multiple of 16 (the
    tensor-core step), more bf16 p.V tiles than the warps hold, or scores and
    ring that do not fit in shared memory even at ``max_cluster`` ranges.
    """
    if T < 1 or B < 1:
        raise ValueError(f"synapse_attention: empty input (B={B}, T={T})")
    if (D * elem_bytes) % 16:
        raise ValueError(f"synapse_attention: a key row of one kv head is D x {elem_bytes} = {D * elem_bytes} "
                         f"bytes, not a multiple of 16 (the bulk and tensor-map copies need it)")
    tc = elem_bytes == 2
    G = H // Hkv
    if not tc and D > 256:
        raise ValueError(f"synapse_attention: D={D} f32 columns exceed the 256 of one tensor-map box")
    if tc and D % 16:
        raise ValueError(f"synapse_attention: D={D} is not a multiple of 16, the depth of a bf16 tensor-core step")
    n_units = D // 16 * -(-G // 8)
    if tc and n_units > UPW * THREADS // 32:
        raise ValueError(f"synapse_attention: G={G} query rows of D={D} make {n_units} p.V tiles of 16 x 8, "
                         f"more than the {UPW * THREADS // 32} the warps hold")
    res = dict(zip(CLUSTER_SIZES, resident))
    row = 128 * -(-D // 64) if tc else D * 4
    if tc:
        slices = 1 if n_units >= THREADS // 32 else THREADS // 32 // n_units
    else:
        slices = min(MAX_SLICES, max(1, THREADS // (D * elem_bytes // 16)))
    GD = G * D
    q_bytes = 8 * -(-G // 8) * (D * 2 + 16) if tc else GD * 4

    def geometry(C):
        ranges = tuple((r * T // C, (r + 1) * T // C) for r in range(C))
        n_max = max(b - a for a, b in ranges)
        HC = Hkv if (Hkv > 1 and C * Hkv in res and B * Hkv * C <= res[C * Hkv]
                     and Hkv * n_max * 4 <= KV_SLOTS_BYTES) else 1
        ck = min(-(-n_max // 16) * 16, max(16, stage_bytes // row // 16 * 16), 256)
        nk = -(-n_max // ck)
        score_pitch = -(-n_max // 32) * 32 + 8
        base = (1024 + BAR_BYTES + align16(q_bytes) + align16(G * score_pitch * 4) + slices * GD * 4
                + align16((2 + 3 * C) * G * 4) + align16(C * -(-GD // C) * 4) + align16(n_max)
                + (align16(HC * n_max * 4) if HC > 1 else 0))
        budget = TWO_PER_SM if B * Hkv * C > res[C * HC] // 2 else MAX_SMEM
        stages = max(2, min(MAX_STAGES, 2 * nk, (budget - base) // (ck * row)))
        return LaunchPlan(
            cluster=C, kv_cluster=HC, ranges=ranges, n_max=n_max, chunk_keys=ck, n_chunks=nk, stages=stages,
            stage_row=row, score_pitch=score_pitch, slices=slices, smem=base + stages * ck * row, grid=(C, Hkv, B),
            mass_parts=Hkv > 1 and HC == 1,
        )

    C = 1
    while 2 * C <= min(max_cluster, T // MIN_KEYS) and B * Hkv * 2 * C <= res[2 * C]:
        C *= 2
    plan = geometry(C)
    while plan.smem > MAX_SMEM and 2 * C <= min(max_cluster, T):
        C *= 2
        plan = geometry(C)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"synapse_attention: a range of {plan.n_max} keys needs {plan.smem} bytes of shared memory "
                         f"for its G={G} rows of scores and the K/V ring, more than the {MAX_SMEM}-byte "
                         f"shared-memory limit, even at {C} ranges")
    return plan


@functools.lru_cache(maxsize=None)
def resident_ctas(device_index: int) -> tuple[int, ...]:
    """The CTAs of the kernel that card ``device_index`` holds at once at two
    an SM, in clusters of each of ``CLUSTER_SIZES``:
    cudaOccupancyMaxActiveClusters times the cluster's CTAs. Clusters pack
    the GPCs unevenly, so the larger ones leave SMs idle. Read once per
    card, from the bf16 instantiation (both hold two 256-thread CTAs an SM
    by their registers: ``__launch_bounds__``)."""
    fn = KERNEL.function("synapse_attention_resident_clusters", [_I] * 4 + [ctypes.POINTER(_I)])
    ctas = []
    with torch.cuda.device(device_index):
        for size in CLUSTER_SIZES:
            n = _I(-1)
            err = fn(size, 1, TWO_PER_SM, 1, ctypes.byref(n))
            if err:
                raise RuntimeError(f"synapse_attention: cudaOccupancyMaxActiveClusters failed for clusters of "
                                   f"{size}: cudaError {err}")
            ctas.append(n.value * size)
    return tuple(ctas)


def card_plan(device, B: int, T: int, H: int, Hkv: int, D: int, elem_bytes: int, **kw) -> LaunchPlan:
    """:func:`launch_plan` on the CUDA ``device``, at what it holds."""
    return launch_plan(B, T, H, Hkv, D, elem_bytes, resident_ctas(torch.device(device).index or 0), **kw)


def _check(q, keys, values, valid):
    if not (q.is_cuda and keys.device == q.device and values.device == q.device and valid.device == q.device):
        raise ValueError("synapse_attention: all inputs must lie on one CUDA device")
    if q.dtype not in _DTYPES or keys.dtype != q.dtype or values.dtype != q.dtype:
        raise TypeError(f"synapse_attention: q/keys/values must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{keys.dtype}/{values.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"synapse_attention: valid must be bool, got {valid.dtype}")
    B, H, D = q.shape
    if keys.dim() != 4 or keys.shape[0] != B or keys.shape[3] != D or values.shape != keys.shape:
        raise ValueError(f"synapse_attention: keys/values {tuple(keys.shape)}/{tuple(values.shape)} "
                         f"do not match q {tuple(q.shape)}")
    T, Hkv = keys.shape[1], keys.shape[2]
    if H % Hkv:
        raise ValueError(f"synapse_attention: H={H} must be a multiple of Hkv={Hkv}")
    if valid.shape != (B, T):
        raise ValueError(f"synapse_attention: valid {tuple(valid.shape)} != {(B, T)}")
    for name, t in (("q", q), ("keys", keys), ("values", values), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"synapse_attention: {name} must be contiguous")
    for name, t in (("q", q), ("keys", keys), ("values", values)):
        if t.data_ptr() % 16:
            raise ValueError(f"synapse_attention: {name} must start at a 16-byte aligned address")


def _check_outputs(q, keys, out, mass):
    B, T = q.shape[0], keys.shape[1]
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device
                            or not out.is_contiguous()):
        raise ValueError(f"synapse_attention: out must be a contiguous {q.dtype} {tuple(q.shape)} on {q.device}")
    if mass is not None and (mass.shape != (B, T) or mass.dtype != torch.float32 or mass.device != q.device
                             or not mass.is_contiguous()):
        raise ValueError(f"synapse_attention: mass must be a contiguous float32 {(B, T)} on {q.device}")


def synapse_attention(q, keys, values, valid, *, scale: float | None = None, out=None, mass=None):
    """q: [B,H,D]; keys/values: [B,T,Hkv,D]; valid: [B,T] bool.

    Returns (out [B,H,D] in q's dtype, mass [B,T] f32). ``scale`` defaults
    to 1/sqrt(D). ``out``/``mass``, where given, are written and returned
    in place of new tensors (a captured tick's static outputs).
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type in ("cpu", "meta"):  # meta: the dry run's shapes and FLOP counts, no launch
        o, m = synapse_attention_ref(q, keys, values, valid, scale=scale)
        if out is None and mass is None:
            return o, m
        _check_outputs(q, keys, out, mass)
        return (o if out is None else out.copy_(o)), (m if mass is None else mass.copy_(m))
    _check(q, keys, values, valid)
    _check_outputs(q, keys, out, mass)
    T, Hkv = keys.shape[1], keys.shape[2]
    return launch(card_plan(q.device, B, T, H, Hkv, D, q.element_size()), q, keys, values, valid, scale,
                  out=out, mass=mass)


def launch(plan: LaunchPlan, q, keys, values, valid, scale: float, *, out=None, mass=None):
    """One launch of the kernel under ``plan`` on inputs that passed the
    wrapper's checks: allocates out and mass unless given and, where the
    plan sums the mass over kv heads in device memory, its workspace."""
    (B, H, D), T, Hkv = q.shape, keys.shape[1], keys.shape[2]
    out = torch.empty_like(q) if out is None else out
    mass = torch.empty((B, T), dtype=torch.float32, device=q.device) if mass is None else mass
    parts = torch.empty((B, Hkv, T), dtype=torch.float32, device=q.device) if plan.mass_parts else None
    tickets = ticket_counters(q.device, B * plan.cluster) if plan.mass_parts else None
    KERNEL.launch(
        q.data_ptr(), keys.data_ptr(), values.data_ptr(), valid.data_ptr(), out.data_ptr(), mass.data_ptr(),
        None if parts is None else parts.data_ptr(), None if tickets is None else tickets.data_ptr(),
        B, T, Hkv, H // Hkv, D, plan.cluster, plan.kv_cluster, plan.n_max, plan.chunk_keys, plan.n_chunks, plan.stages,
        plan.slices, plan.smem, float(scale), _DTYPES[q.dtype],
    )
    return out, mass
