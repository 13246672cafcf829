"""Which DTensor paths of the port run under this host's torch (DTensor's
rules differ between torch releases).

    python3 tools/dtensor_probe.py train ARCH [ARCH ...]   # two sharded train steps, fake (2, 2) mesh, CPU tensors
    python3 tools/dtensor_probe.py dry ARCH [ARCH ...]     # every dry-run kind, fake (32, 8) mesh, meta tensors

Reduced configs; no card and no second process: a fake process group
carries out no collective. One line per combo: OK with its seconds, SKIP,
or FAIL with the error and the last line of the port it passed through.
"""
import dataclasses, sys, time, traceback
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
import torch, torch.distributed as dist
torch.set_num_threads(1)
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.train import mesh_step, place_state
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import init_train_state, make_train_step
from repro_torch.data.pipeline import DataConfig, batch_to, make_batch

def where(e):
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename and not f.filename.endswith("dryrun.py")]
    f = frames[-1] if frames else None
    if f is None:
        return repr(e)[:300]
    return f"{type(e).__name__}: {str(e)[:300]!r} at {f.filename.split('src/')[-1]}:{f.lineno} {f.line}"

archs = sys.argv[2:]
if sys.argv[1] == "train":
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in archs:
        t = time.time()
        try:
            cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
            state = place_state(init_train_state(cfg, device="cpu"), cfg, mesh)
            step = mesh_step(make_train_step(cfg, AdamWConfig()), cfg, mesh)
            for i in range(2):
                state, m = step(state, batch_to(make_batch(cfg, DataConfig(seq_len=32, batch_size=4, seed=i)), "cpu"))
            print(f"PROBE train2x2 {arch}: OK {time.time() - t:.1f}s", flush=True)
        except Exception as e:
            print(f"PROBE train2x2 {arch}: FAIL {where(e)}", flush=True)
else:
    mesh = dryrun.fake_mesh(False)
    for arch in archs:
        for shape in specs.SHAPES:
            t = time.time()
            try:
                cfg = get_config(arch, reduced=True)
                plan = specs.plan_for(cfg, shape)
                if plan.skip:
                    print(f"PROBE dry32x8 {arch} {shape}: SKIP", flush=True)
                    continue
                fn, args, _ = dryrun.build_lowerable(arch, shape, mesh, cfg=cfg)
                try:
                    dryrun.measure(fn, args, mesh, train=plan.kind == "train")
                finally:
                    model_lib.set_activation_sharding(None)
                print(f"PROBE dry32x8 {arch} {shape}: OK {time.time() - t:.1f}s", flush=True)
            except Exception as e:
                print(f"PROBE dry32x8 {arch} {shape}: FAIL {where(e)}", flush=True)
