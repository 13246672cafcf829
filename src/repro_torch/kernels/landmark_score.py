"""Hybrid landmark scoring sweep (paper §3.3): the CUDA kernel
``csrc/landmark_score.cu`` and its wrapper.

One pass over a KV cache gives, when a landmark set is given, each key's
coverage distance to it, and one of two things: the per-head density
logits (:func:`landmark_score`, the TPU kernel's output), or the density
itself, the valid-masked softmax over the keys summed over heads
(:func:`landmark_density`, what the spawn uses), without writing the
[B, H, T] logits. A CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import CudaKernel, align16, ticket_counters
from repro_torch.kernels.ref import landmark_density_ref, landmark_score_ref

MAX_SMEM = 232_448     # bytes of shared memory a block may use on sm_90
SMEM_PER_SM = 233_472  # of which each resident block also takes 1 KB
TWO_PER_SM = SMEM_PER_SM // 2 - 1024  # shared memory a CTA may take with another beside it
THREADS = 256
MAX_CLUSTER = 16       # ranges per lane in density mode: one cluster, non-portable above 8
MAX_RANGES = 64        # ranges per lane in logits mode (no cluster)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # the cluster sizes a plan may take, and ``resident_ctas`` reads
MIN_KEYS = 32          # keys a range keeps at least, where T allows
STAGE_BYTES = 32768    # bytes of keys one ring stage holds, about (at least 16 keys)
MAX_STAGES = 8
BAR_BYTES = 128        # the mbarriers, one per ring stage
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "landmark_score", "landmark_score_launch",
    [_P] * 9 + [_I] * 13 + [_F, _F, _I, _P],
)


def _logit_pitch(n: int) -> int:
    return -(-n // 32) * 32 + 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one launch: a grid of (``ranges_per_lane``,
    ``head_groups``, B) CTAs of ``THREADS`` threads, one per (key range,
    kv-head group, lane), Hkv / ``head_groups`` kv heads of a key in one CTA;
    in density mode the CTAs of a (lane, group) are one cluster
    (``cluster``; 1 in logits mode), and with more than one group each
    writes its group's density to a [B, head_groups, T] f32 workspace
    (``parts``) that the CTA drawing the last of a [B, ranges] int32 ticket
    counter's tickets sums. CTA r owns the keys ``ranges[r]``, at
    most ``n_max``; they pass through a ring of ``stages`` stages of
    ``chunk_keys`` keys (one tensor-map copy per 64 columns, ``stage_bytes``),
    ``n_chunks`` tiles a range at most. With ``keep`` the range's [H, n]
    f32 logits stay in shared memory between the softmax's two steps;
    without it (density mode at long key sets) a second sweep loads the
    tiles again. ``smem`` bytes of dynamic shared memory per CTA; nothing
    in device memory beyond the outputs."""

    density: bool
    ranges_per_lane: int
    head_groups: int
    cluster: int
    ranges: tuple[tuple[int, int], ...]
    n_max: int
    chunk_keys: int
    n_chunks: int
    stages: int
    stage_bytes: int
    keep: bool
    smem: int
    grid: tuple[int, int, int]
    threads: int = THREADS

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def parts(self) -> bool:
        return self.head_groups > 1

    @property
    def sweeps(self) -> int:
        return 2 if self.density and not self.keep else 1


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, T: int, H: int, Hkv: int, D: int, Kc: int, elem_bytes: int, resident: tuple[int, ...], *,
                density: bool = False, stage_bytes: int = STAGE_BYTES, max_ranges: int | None = None) -> LaunchPlan:
    """The launch geometry for q [B,H,D], keys [B,T,Hkv,D] and ``Kc``
    landmarks (0 for the density-only sweep) of ``elem_bytes`` per value
    (2: bf16 on tensor cores; 4: f32), in density mode or logits mode, on a
    card that holds ``resident[i]`` CTAs at once, two an SM, in clusters of
    ``CLUSTER_SIZES[i]`` (:func:`resident_ctas` reads them); the kernel
    carves its shared memory by the same sums (``smem_bytes`` in the
    source) and refuses a plan that disagrees.

    The ranges per lane: the most, a power of two up to ``max_ranges``
    (default and at most ``MAX_CLUSTER`` in density mode, ``MAX_RANGES`` in
    logits mode) and at most T // ``MIN_KEYS``, whose grid the card holds in
    one wave; then, in density mode without landmarks, the most kv-head
    groups (a power of two dividing Hkv) whose grid still does; where no
    tile fits beside a range's rows, half as many ranges, and so on. A
    tile is about ``stage_bytes`` of keys (16 at least, a multiple of 16,
    at most 256 and at most the range); as many ring stages (up to
    ``MAX_STAGES``, at most the tiles a CTA loads) as the shared memory
    leaves room for, with a second CTA on the SM where the grid needs it.
    In density mode the range's logits stay in shared memory where they fit
    beside one stage; else the kernel sweeps the keys twice, so no T is
    refused for them. ``stage_bytes`` and ``max_ranges`` are there for
    ``tools/kernel_bench.py --sweep``; every path of the port takes the
    defaults.

    Raises ValueError naming the reason where the kernel cannot take the
    shape: a kv head's key row whose bytes are not a multiple of 16 (the
    tensor-map copy needs it), a bf16 head width that is not a multiple of
    16 (the tensor-core step), more f32 columns or kv heads than one
    tensor-map box takes, or queries, landmarks and the mask of a range
    that leave no room for a tile in shared memory.
    """
    if T < 1 or B < 1:
        raise ValueError(f"landmark_score: empty input (B={B}, T={T})")
    if (D * elem_bytes) % 16:
        raise ValueError(f"landmark_score: a key row of one kv head is D x {elem_bytes} = {D * elem_bytes} "
                         f"bytes, not a multiple of 16 (the tensor-map copy needs it)")
    tc = elem_bytes == 2
    if tc and D % 16:
        raise ValueError(f"landmark_score: D={D} is not a multiple of 16, the depth of a bf16 tensor-core step")
    if not tc and D > 256:
        raise ValueError(f"landmark_score: D={D} f32 columns exceed the 256 of one tensor-map box")
    if Hkv > 256:
        raise ValueError(f"landmark_score: Hkv={Hkv} kv heads exceed the 256 of one tensor-map box")
    res = dict(zip(CLUSTER_SIZES, resident))
    wave = lambda C: res[C if density else 1]
    cap = min(MAX_CLUSTER, max_ranges or MAX_CLUSTER) if density else (max_ranges or MAX_RANGES)

    def geometry(C, HG, keep, budget):
        hg = Hkv // HG  # kv heads of one CTA
        Hq = hg * (H // Hkv)
        row = hg * (128 * -(-D // 64) if tc else D * 4)  # bytes of one key in a stage
        q_bytes = (Hq + tc) * D * elem_bytes  # bf16: a zero row after the queries
        ranges = tuple((r * T // C, (r + 1) * T // C) for r in range(C))
        n_max = max(b - a for a, b in ranges)
        ck = min(-(-n_max // 16) * 16, max(16, stage_bytes // row // 16 * 16), 256)
        nk = -(-n_max // ck)
        base = (1024 + BAR_BYTES + align16(q_bytes) + align16(Kc * (D + 1) * 4)
                + align16(Hq * _logit_pitch(n_max if keep else ck) * 4)
                + align16((4 + 2 * (C if density else 1)) * Hq * 4) + align16(n_max) + align16((nk + 3) * 4))
        stages = min(MAX_STAGES, nk * (2 if density and not keep else 1), (budget - base) // (ck * row))
        return LaunchPlan(
            density=density, ranges_per_lane=C, head_groups=HG, cluster=C if density else 1, ranges=ranges,
            n_max=n_max, chunk_keys=ck, n_chunks=nk, stages=stages, stage_bytes=ck * row, keep=keep,
            smem=base + max(stages, 1) * ck * row, grid=(C, HG, B))

    C = 1
    while 2 * C <= min(cap, T // MIN_KEYS) and B * 2 * C <= wave(2 * C):
        C *= 2
    # where no tile fits beside a range's rows, fewer ranges (and in
    # density mode more kv-head groups, fewer query rows a CTA) are tried
    while True:
        HG = 1
        while density and not Kc and Hkv % (2 * HG) == 0 and B * C * 2 * HG <= wave(C):
            HG *= 2
        budgets = ((TWO_PER_SM,) if B * C * HG > wave(C) // 2 else ()) + (MAX_SMEM,)
        for budget in budgets:
            for keep in ((True, False) if density else (False,)):
                plan = geometry(C, HG, keep, budget)
                if plan.stages >= 1:
                    return plan
        if C == 1:
            break
        C //= 2
    raise ValueError(f"landmark_score: a tile of {plan.chunk_keys} keys beside the {H} query rows, {Kc} landmarks "
                     f"and a range's mask of {plan.n_max} keys needs {plan.smem} bytes, more than the "
                     f"{MAX_SMEM}-byte shared-memory limit")


@functools.lru_cache(maxsize=None)
def resident_ctas(device_index: int) -> tuple[int, ...]:
    """The CTAs of the kernel that card ``device_index`` holds at once at two
    an SM, in clusters of each of ``CLUSTER_SIZES``:
    cudaOccupancyMaxActiveClusters times the cluster's CTAs. Read once per
    card, from the bf16 density-mode instantiation (all hold two 256-thread CTAs an SM
    by their registers: ``__launch_bounds__``)."""
    fn = KERNEL.function("landmark_score_resident_clusters", [_I] * 3 + [ctypes.POINTER(_I)])
    ctas = []
    with torch.cuda.device(device_index):
        for size in CLUSTER_SIZES:
            n = _I(-1)
            err = fn(size, TWO_PER_SM, 1, ctypes.byref(n))
            if err:
                raise RuntimeError(f"landmark_score: cudaOccupancyMaxActiveClusters failed for clusters of "
                                   f"{size}: cudaError {err}")
            ctas.append(n.value * size)
    return tuple(ctas)


def card_plan(device, B: int, T: int, H: int, Hkv: int, D: int, Kc: int, elem_bytes: int, **kw) -> LaunchPlan:
    """:func:`launch_plan` on the CUDA ``device``, at what it holds."""
    return launch_plan(B, T, H, Hkv, D, Kc, elem_bytes, resident_ctas(torch.device(device).index or 0), **kw)


def _check(q, keys, landmarks, valid=None):
    ins = [("q", q), ("keys", keys)] + ([("landmarks", landmarks)] if landmarks is not None else [])
    for name, t in ins + ([("valid", valid)] if valid is not None else []):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"landmark_score: {name} must lie on q's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"landmark_score: {name} must be contiguous")
    for name, t in ins:
        if t.dtype != q.dtype:
            raise TypeError(f"landmark_score: {name} is {t.dtype}, q is {q.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"landmark_score: {name} must start at a 16-byte aligned address")
    if q.dtype not in _DTYPES:
        raise TypeError(f"landmark_score: dtype {q.dtype} not in {list(_DTYPES)}")
    B, H, D = q.shape
    if keys.dim() != 4 or keys.shape[0] != B or keys.shape[3] != D:
        raise ValueError(f"landmark_score: keys {tuple(keys.shape)} do not match q {tuple(q.shape)}")
    T, Hkv = keys.shape[1], keys.shape[2]
    if H % Hkv:
        raise ValueError(f"landmark_score: H={H} must be a multiple of Hkv={Hkv}")
    if landmarks is not None:
        if landmarks.dim() != 3 or landmarks.shape[0] != B or landmarks.shape[2] != D or landmarks.shape[1] < 1:
            raise ValueError(f"landmark_score: landmarks {tuple(landmarks.shape)} != [B, Kc >= 1, {D}]")
    if valid is not None:
        if valid.dtype != torch.bool:
            raise TypeError(f"landmark_score: valid must be bool, got {valid.dtype}")
        if valid.shape != (B, T):
            raise ValueError(f"landmark_score: valid {tuple(valid.shape)} != {(B, T)}")


def landmark_score(q, keys, landmarks=None, *, scale: float | None = None):
    """Logits mode. q: [B,H,D]; keys: [B,T,Hkv,D]; landmarks: [B,Kc,D] or
    None.

    Returns (logits [B,H,T] f32, min_dist [B,T] f32 or None); distances
    are normalised by sqrt(D).
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type in ("cpu", "meta"):  # meta: the dry run's shapes and FLOP counts, no launch
        return landmark_score_ref(q, keys, landmarks, scale=scale)
    _check(q, keys, landmarks)
    T, Hkv = keys.shape[1], keys.shape[2]
    kc = 0 if landmarks is None else landmarks.shape[1]
    return launch(card_plan(q.device, B, T, H, Hkv, D, kc, q.element_size()), q, keys, landmarks, None, scale)


def landmark_density(q, keys, landmarks=None, valid=None, *, scale: float | None = None):
    """Density mode. q: [B,H,D]; keys: [B,T,Hkv,D]; landmarks: [B,Kc,D] or
    None; valid: [B,T] bool, or None for every key valid.

    Returns (density [B,T] f32: sum over heads of each head's softmax over
    the valid keys, min_dist [B,T] f32 or None), one launch on a CUDA
    tensor.
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type in ("cpu", "meta"):
        return landmark_density_ref(q, keys, valid, landmarks, scale=scale)
    _check(q, keys, landmarks, valid)
    T, Hkv = keys.shape[1], keys.shape[2]
    kc = 0 if landmarks is None else landmarks.shape[1]
    plan = card_plan(q.device, B, T, H, Hkv, D, kc, q.element_size(), density=True)
    return launch(plan, q, keys, landmarks, valid, scale)


def launch(plan: LaunchPlan, q, keys, landmarks, valid, scale: float):
    """One launch of the kernel under ``plan`` on inputs that passed the
    wrapper's checks: allocates the outputs, logits [B,H,T] or density
    [B,T] as the plan's mode says, and dist [B,T] with landmarks, and the
    plan's [B, head_groups, T] workspace where it has one."""
    (B, H, D), T, Hkv = q.shape, keys.shape[1], keys.shape[2]
    kc = 0 if landmarks is None else landmarks.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, T) if plan.density else (B, H, T), **f32)
    dist = None if landmarks is None else torch.empty((B, T), **f32)
    parts = torch.empty((B, plan.head_groups, T), **f32) if plan.parts else None
    tickets = ticket_counters(q.device, B * plan.ranges_per_lane) if plan.parts else None
    ptr = lambda t: None if t is None else t.data_ptr()
    KERNEL.launch(
        q.data_ptr(), keys.data_ptr(), ptr(landmarks), ptr(valid),
        None if plan.density else out.data_ptr(), out.data_ptr() if plan.density else None, ptr(dist),
        ptr(parts), ptr(tickets), B, T, Hkv, H // Hkv, D, kc, plan.ranges_per_lane, plan.head_groups, plan.n_max,
        plan.chunk_keys, plan.stages, int(plan.keep), plan.smem, float(scale), float(D), _DTYPES[q.dtype],
    )
    return out, dist
