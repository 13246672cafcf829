"""The dry run: one step of every (arch x input shape) on the production
mesh of an H100 cluster, without the cluster.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --lane 1024
    PYTHONPATH=src python -m repro_torch.launch.dryrun --registry 10000

Port of the JAX package's ``repro.launch.dryrun``. The reference lowers and
compiles each step for 512 forced host devices and reads XLA's analyses.
Here the step runs once, eagerly, in one process that is rank 0 of a fake
process group of 256 ranks, (32, 8), or 512, (2, 32, 8)
(``repro_torch.launch.mesh``): params, inputs and caches are DTensors of
``meta`` tensors placed by ``repro_torch.launch.sharding``, so every op
runs its placement rule and its collectives (which the fake group does not
carry out) and allocates nothing. What rank 0 records:

* ``argument_bytes``: the bytes of its shards of every argument (the
  counterpart of XLA's ``argument_size_in_bytes``);
* ``saved_bytes`` (train): the bytes autograd saves for the backward pass
  that are not arguments, from ``torch.autograd.graph.saved_tensors_hooks``
  (the counterpart of ``temp_size_in_bytes``; layers rematerialised by
  the config save only their inputs, and the recomputation inside the
  backward pass is not counted);
* ``collectives``: the bytes each collective produces on this rank, by
  kind and by mesh axis (the counterpart of ``parse_collectives``). The
  fake group, like gloo, has no all-to-all: DTensor moves a shard from one
  dim to another by an all-gather there, where NCCL would run an
  all-to-all;
* ``flops`` and ``bytes``: the local aten ops' FLOPs (PyTorch's
  ``FlopCounterMode`` formulas) and the bytes each op reads and writes
  (its tensor inputs and outputs; views and allocations move none). Eager
  PyTorch runs each op as its own kernel, so this is the port's traffic.

Status is ``OK``, ``SKIP`` (the reference's skips, from ``plan_for``) or
``FAIL`` with the traceback. Artifacts go under ``build/launch/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import DRYRUN_SHAPES, HOST_CARDS, MODEL_AXIS, data_axes, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import abstract_train_state, make_train_step

OUT_ROOT = Path(__file__).resolve().parents[3] / "build" / "launch"

_c10d = torch.ops._c10d_functional
COLLECTIVES = {
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.all_reduce: "all-reduce",
    _c10d.all_to_all_single: "all-to-all",
    _c10d.broadcast: "broadcast",
}
# ops that move no tensor bytes (allocations, autograd bookkeeping)
_FREE = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
         torch.ops.aten.detach, torch.ops.aten.alias, torch.ops.aten.lift_fresh}


# ---------------------------------------------------------------------------
# counting one rank's work
# ---------------------------------------------------------------------------
def _local(t) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def nbytes(t) -> int:
    """Bytes of this rank's shard of ``t``."""
    t = _local(t)
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    return sum(nbytes(t) for t in tree_leaves(_as_pytree(tree)) if isinstance(t, torch.Tensor))


def _as_pytree(tree):
    """The port's trees (dicts, lists, dataclasses) as nested containers
    ``torch.utils._pytree`` walks."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [_as_pytree(getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return {k: _as_pytree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_pytree(v) for v in tree]
    return tree


class StepCounter(TorchDispatchMode):
    """The local aten ops this rank runs. A DTensor op is handed back to
    DTensor (``NotImplemented``), which runs its placement rule,
    redistributes, and calls the local op on the shards: that local op,
    and each collective of a redistribution, comes back here. Ops on fake
    tensors (DTensor's shape propagation) or off the meta device (its
    placement-cost arithmetic) are not the step's and are skipped."""

    def __init__(self, mesh):
        super().__init__()
        self.axis_of = {} if mesh is None else {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives: dict[str, dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat = [a for a in tree_leaves((args, kwargs, out)) if isinstance(a, torch.Tensor)]
        if any(isinstance(a, FakeTensor) or a.device.type != "meta" for a in flat):
            return out  # DTensor's own bookkeeping: the step's tensors are all on meta
        packet = func._overloadpacket
        kind = COLLECTIVES.get(packet)
        if kind is not None:
            group = next(a for a in reversed(args) if isinstance(a, str))
            axis = self.axis_of.get(group, group)
            by = self.collectives.setdefault(kind, {})
            by[axis] = by.get(axis, 0) + sum(nbytes(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
            return out
        if func.namespace == "_c10d_functional":  # wait_tensor and kin
            return out
        self.n_ops += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _FREE:
            self.bytes += sum(nbytes(t) for t in flat)
        return out

    def summary(self) -> dict:
        per_kind = {k: sum(v.values()) for k, v in self.collectives.items()}
        per_axis: dict[str, int] = {}
        for by in self.collectives.values():
            for a, b in by.items():
                per_axis[a] = per_axis.get(a, 0) + b
        return {"flops": self.flops, "bytes": self.bytes, "n_ops": self.n_ops,
                "collectives": {"by_kind_axis": self.collectives, "per_kind": per_kind,
                                "per_axis": per_axis, "total_bytes": sum(per_kind.values())}}


class SavedBytes:
    """Bytes autograd saves for backward on this rank, each storage once,
    the arguments' own storages left out."""

    def __init__(self, args):
        self.skip = {_local(t).untyped_storage()._cdata
                     for t in tree_leaves(_as_pytree(args)) if isinstance(t, torch.Tensor)}
        self.seen: set = set()
        self.bytes = 0

    def pack(self, t):
        loc = _local(t)
        key = loc.untyped_storage()._cdata
        if key not in self.skip and key not in self.seen:
            self.seen.add(key)
            self.bytes += loc.untyped_storage().nbytes()
        return t

    @staticmethod
    def unpack(t):
        return t


def measure(fn, args, mesh, *, train: bool) -> dict:
    """Run ``fn(*args)`` once on ``mesh`` and count rank 0's work."""
    counter = StepCounter(mesh)
    saved = SavedBytes(args)
    hooks = (torch.autograd.graph.saved_tensors_hooks(saved.pack, saved.unpack) if train
             else contextlib.nullcontext())
    grad = contextlib.nullcontext() if train else torch.no_grad()
    with implicit_replication(), grad, hooks, counter:
        fn(*args)
    rec = counter.summary()
    rec["memory"] = {"argument_bytes": local_bytes(args)}
    if train:
        rec["memory"]["saved_bytes"] = saved.bytes
    return rec


# ---------------------------------------------------------------------------
# the production meshes over a fake group
# ---------------------------------------------------------------------------
_FAKE_MESHES: dict = {}


def fake_mesh(multi_pod: bool):
    """The (32, 8) or (2, 32, 8) production mesh, this process rank 0 of a
    fake group of that size (made anew when the size changes). One mesh
    per group: DTensor caches its redistribution plans by mesh shape and
    names, so a second equal mesh would run on the first one's groups."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(DRYRUN_SHAPES[multi_pod])
    if dist.is_initialized() and (dist.get_backend() != "fake" or dist.get_world_size() != world):
        dist.destroy_process_group()
        _FAKE_MESHES.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    if multi_pod not in _FAKE_MESHES:
        _FAKE_MESHES[multi_pod] = make_production_mesh(multi_pod, device="cpu", per_host=HOST_CARDS)
    return _FAKE_MESHES[multi_pod]


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


# ---------------------------------------------------------------------------
# one (arch x shape)
# ---------------------------------------------------------------------------
def activation_spec(plan: specs_lib.ShapePlan, mesh, act_mode: str = "auto"):
    """"auto": sequence-parallel saves for the full-sequence kinds,
    batch-only for decode; "batch": batch-only; "off": no anchors."""
    dp = data_axes(mesh)
    if act_mode == "off":
        return None
    if plan.kind == "decode" or act_mode == "batch":
        return (dp, None, None)
    return (dp, MODEL_AXIS, None)


def build_lowerable(arch: str, shape_name: str, mesh, *, act_mode: str = "auto", fsdp_on: bool = True,
                    synapse_token_shard: bool = True, cfg: ModelConfig | None = None,
                    plan: specs_lib.ShapePlan | None = None):
    """Returns (fn, args, plan): ``fn(*args)`` is the step on ``mesh`` with
    every argument a DTensor of meta tensors (``mesh`` None: plain meta
    tensors, one device). Sets the model's activation anchors (reset them
    with ``set_activation_sharding(None)``). ``cfg`` and ``plan`` default
    to the arch's config and the shape's plan.

    synapse_token_shard=False replicates the synapse buffers' token dim.
    With it set, DTensor's own rules place the decode's ops on the
    token-sharded buffers (gathering where an op needs the whole dim): the
    reference's scoped flash-decode ``shard_map`` has no DTensor
    counterpart here."""
    cfg = cfg or get_config(arch)
    plan = plan or specs_lib.plan_for(cfg, shape_name)
    if plan.skip:
        return None, None, plan
    if mesh is not None:
        model_lib.set_activation_sharding(activation_spec(plan, mesh, act_mode))

    def place(tree, rule, **kw):
        return tree if mesh is None else shard_lib.distribute(tree, rule(tree, cfg, mesh, **kw), mesh)

    if plan.kind == "train":
        state = place(abstract_train_state(cfg), shard_lib.param_specs, fsdp_on=fsdp_on)
        batch = place(specs_lib.train_batch_specs(cfg, plan.seq, plan.batch), shard_lib.batch_specs)
        return make_train_step(cfg, AdamWConfig()), (state, batch), plan

    params = place(model_lib.abstract_params(cfg), shard_lib.param_specs, fsdp_on=fsdp_on)
    inputs, cache_spec = specs_lib.input_specs(cfg, plan)
    inputs = place(inputs, shard_lib.batch_specs)
    if plan.kind == "prefill" and cfg.is_encoder_only:
        return (lambda p, i: model_lib.forward(p, cfg, i)), (params, inputs), plan
    caches = place(specs_lib.abstract_caches(cfg, plan)[0], shard_lib.cache_specs,
                   synapse_token_shard=synapse_token_shard)
    step = model_lib.prefill if plan.kind == "prefill" else model_lib.decode_step
    # the reference's prefill and decode cast the params inside the step;
    # the port's take them cast (the engine casts once)
    return ((lambda p, i, c: step(model_lib.cast_params(p, cfg), cfg, i, c, spec=cache_spec)),
            (params, inputs, caches), plan)


def _write(rec: dict, out_dir, name: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def run_one(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str | None, **kw) -> dict:
    mesh = fake_mesh(multi_pod)
    name = mesh_name(mesh)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": name}
    t0 = time.time()
    try:
        fn, args, plan = build_lowerable(arch, shape_name, mesh, **kw)
        if plan.skip:
            rec.update(status="SKIP", reason=plan.skip)
            print(f"[dryrun] {arch} x {shape_name} on {name}: SKIP ({plan.skip})")
        else:
            rec.update(kind=plan.kind, cache_kind=plan.cache_kind, seq=plan.seq, batch=plan.batch)
            rec.update(measure(fn, args, mesh, train=plan.kind == "train"))
            rec.update(status="OK", step_s=round(time.time() - t0, 2))
            mem = rec["memory"]
            print(f"[dryrun] {arch} x {shape_name} on {name}: OK ({rec['step_s']:.1f}s host, "
                  f"args/rank {mem['argument_bytes'] / 1e9:.2f}GB, saved/rank {mem.get('saved_bytes', 0) / 1e9:.2f}GB, "
                  f"coll/rank {rec['collectives']['total_bytes'] / 1e9:.2f}GB)")
    except Exception as e:  # a failure here is a fault of the port: recorded, the run goes on
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name} on {name}: FAIL {type(e).__name__}: {e}")
    finally:
        model_lib.set_activation_sharding(None)
    _write(rec, out_dir, f"{arch}__{shape_name}__{name}.json")
    return rec


# ---------------------------------------------------------------------------
# the lane-sharded engine's state, and the tiered registry
# ---------------------------------------------------------------------------
def _tick_state(cfg, *, n_main: int, max_side: int, main_spec, side_spec, ring: int):
    from repro_torch.core import engine as engine_lib
    from repro_torch.serving.sampler import SamplingParams

    greedy = SamplingParams(greedy=True)
    return engine_lib.init_tick_state(
        cfg, n_main=n_main, max_side=max_side, main_spec=main_spec, side_spec=side_spec,
        ring_capacity=ring, side_prompt_cap=64, main_sampling=greedy, side_sampling=greedy,
        seed=0, device="meta")


def run_lane(n_side: int, *, n_devices: int = 8, sync_every: int = 8, out_dir: str | None = None) -> dict:
    """The lane-sharded engine's state at ``max_side = n_side`` on a lane
    group of ``n_devices`` ranks, on ``meta`` (nothing is allocated): the
    ``TickState`` bytes each rank holds (its block of ``n_side / n_devices``
    side lanes, the river replicated) and the ring bytes each drain
    gathers from every rank. The reference's geometry: reduced
    Qwen2.5-0.5B in f32, a full river cache of 128 slots, synapse side
    caches (64 landmarks, 64 window, 16 inject), a ring of ``sync_every``."""
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    if n_side % n_devices:
        raise ValueError(f"--lane {n_side}: not a multiple of the lane group's {n_devices} ranks")
    main_spec = model_lib.CacheSpec(kind="full", capacity=128)
    side_spec = model_lib.CacheSpec(kind="synapse", n_landmarks=64, window=64, n_inject=16)
    block = n_side // n_devices
    st = _tick_state(cfg, n_main=1, max_side=block, main_spec=main_spec, side_spec=side_spec, ring=sync_every)
    side = {f.name: getattr(st, f.name) for f in dataclasses.fields(st) if f.name.startswith("side_")}
    state_bytes = local_bytes(st) - nbytes(st.main_ring) - nbytes(st.side_ring)  # views of ``rings``
    rec = {"kind": "lane_state", "n_side": n_side, "lane_group": n_devices, "block": block,
           "sync_every": sync_every, "state_bytes_per_rank": state_bytes,
           "side_bytes_per_rank": local_bytes(side) - nbytes(st.side_ring),
           "weight_bytes": local_bytes(model_lib.abstract_params(cfg)),
           "ring_bytes_per_drain": n_devices * nbytes(st.side_ring) + nbytes(st.main_ring), "status": "OK"}
    print(f"[dryrun] lane state n_side={n_side} on a {n_devices}-rank lane group: {block} side lanes/rank, "
          f"state {state_bytes / 1e6:.2f}MB/rank (side lanes {rec['side_bytes_per_rank'] / 1e6:.2f}MB), "
          f"ring gathered per drain {rec['ring_bytes_per_drain']} B")
    _write(rec, out_dir, f"lane__s{n_side}__d{n_devices}.json")
    return rec


def run_registry(n_registered: int, *, arch: str = "qwen2.5-0.5b", n_active: int = 8, main_capacity: int = 1024,
                 out_dir: str | None = None) -> dict:
    """Abstract tiered-memory accounting: what ``n_registered`` agents cost
    when only ``n_active`` hold device lanes.

    Everything is on ``meta``: the per-agent snapshot is the exact tree
    ``CortexEngine.hibernate`` gathers (``gather_main_lane`` over the
    state), so the bytes are the real hibernation payload at full
    ``main_capacity``, computed without a buffer. The same math at 1M agents
    is the paper's capacity claim: device cost is flat in
    ``n_registered`` (weights + active lanes only); dormant agents ride
    host RAM and the cold tier's disk. The cold codec's ratio is measured
    on synthetic float32 noise: a LOWER bound (real KV activations
    compress better than noise)."""
    import numpy as np

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import engine as engine_lib

    cfg = get_config(arch)
    main_spec = model_lib.CacheSpec(kind="full", capacity=main_capacity)
    side_spec = model_lib.CacheSpec(kind="synapse", n_landmarks=64, window=64, n_inject=16)
    st = _tick_state(cfg, n_main=n_active, max_side=8, main_spec=main_spec, side_spec=side_spec, ring=8)
    snap = engine_lib.gather_main_lane(st, 0)
    per_agent = local_bytes(snap)
    weight_bytes = local_bytes(model_lib.abstract_params(cfg))

    rng = np.random.default_rng(0)
    noise = ckpt_io.tree_map(
        lambda t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(t.dtype)
        if t.is_floating_point() else torch.from_numpy(rng.integers(0, 2, tuple(t.shape))).to(t.dtype), snap)
    codec = ckpt_io.default_codec()
    ratio = per_agent / len(ckpt_io.dumps_framed(noise, codec=codec))

    def tier_table(n: int) -> dict:
        dormant = max(0, n - n_active)
        warm = dormant * per_agent
        return {"n_registered": n, "device_bytes": weight_bytes + n_active * per_agent,
                "warm_bytes_all_host": warm, "cold_bytes_all_disk": int(warm / ratio),
                "device_bytes_if_all_resident": weight_bytes + n * per_agent}

    rec = {"kind": "registry_tiers", "arch": arch, "n_active": n_active, "main_capacity": main_capacity,
           "per_agent_snapshot_bytes": per_agent, "weight_bytes": weight_bytes,
           "cold_codec": ckpt_io.codec_name(codec), "cold_ratio_noise_floor": ratio,
           "at_n": tier_table(n_registered), "at_1m": tier_table(1_000_000)}
    t, m = rec["at_n"], rec["at_1m"]
    print(f"[dryrun] registry {arch}: {n_registered} registered / {n_active} active @ capacity {main_capacity}: "
          f"snapshot/agent {per_agent / 1e6:.2f}MB; device {t['device_bytes'] / 1e9:.2f}GB "
          f"(vs {t['device_bytes_if_all_resident'] / 1e9:.2f}GB all-resident), host "
          f"{t['warm_bytes_all_host'] / 1e9:.2f}GB, disk {t['cold_bytes_all_disk'] / 1e9:.2f}GB "
          f"({rec['cold_codec']} ratio >= {ratio:.2f})")
    print(f"[dryrun] registry {arch}: extrapolated 1M agents: device {m['device_bytes'] / 1e9:.2f}GB flat, "
          f"host+disk spill {m['warm_bytes_all_host'] / 1e12:.2f}TB raw, vs "
          f"{m['device_bytes_if_all_resident'] / 1e12:.2f}TB if all resident")
    _write(rec, out_dir, f"registry__{arch}__{n_registered}.json")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(specs_lib.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(OUT_ROOT / "dryrun"))
    ap.add_argument("--lane", type=int, default=None, metavar="N_SIDE",
                    help="the lane-sharded engine's state at N_SIDE side lanes on an 8-rank lane group "
                         "(e.g. --lane 1024)")
    ap.add_argument("--registry", type=int, default=None, metavar="N",
                    help="tiered-memory accounting for N registered agents over --registry-active lanes "
                         "(e.g. --registry 10000), with the 1M-agent extrapolation")
    ap.add_argument("--registry-active", type=int, default=8)
    args = ap.parse_args(argv)

    if args.registry is not None:
        return run_registry(args.registry, arch=args.arch or "qwen2.5-0.5b", n_active=args.registry_active,
                            out_dir=args.out)
    if args.lane is not None:
        return run_lane(args.lane, out_dir=args.out)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    archs = [a for a in archs if a != "qwen2.5-0.5b" or args.arch == a]
    shapes = list(specs_lib.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = [run_one(a, s, multi_pod=mp, out_dir=args.out) for mp in meshes for a in archs for s in shapes]
    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"] == "SKIP" for r in results)
    fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n[dryrun] {ok} OK, {skip} SKIP, {fail} FAIL / {len(results)} combos")
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
