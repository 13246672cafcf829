"""The port stands alone and never falls back to the CPU: importing every
``repro_torch`` module pulls in neither ``jax`` nor the JAX package, and
the entry points refuse to run without a card unless asked for the CPU."""
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as tmodel

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.bridge", "repro_torch.core.engine", "repro_torch.kernels.ops",
            "repro_torch.memory.registry", "repro_torch.serving.server", "repro_torch.serving.frontend",
            "repro_torch.serving.transport", "repro_torch.launch.serve", "repro_torch.checkpoint.io",
            "repro_torch.memory.store", "repro_torch.memory.faults"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
               or m == "repro" or m.startswith("repro.")]
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_tiers_run_on_the_card_hosts_packages(tmp_path):
    """The card's host has no msgpack, zstandard, xxhash, ml_dtypes or JAX:
    with each of them blocked, every port module imports, and a bf16 lane
    snapshot goes through the store's cold tier (zlib and crc32 frames) and
    back bitwise."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("msgpack", "zstandard", "xxhash", "ml_dtypes", "jax", "jaxlib", "repro"):
            sys.modules[name] = None  # import raises ImportError
        import importlib, torch
        for m in {_modules()!r}:
            importlib.import_module(m)
        from repro_torch.checkpoint import io
        from repro_torch.memory import SynapseStore
        assert io.zstandard is None and io.xxhash is None
        assert io.default_codec() == io.CODEC_ZLIB
        g = torch.Generator().manual_seed(0)
        snap = {{"caches": torch.randn(2, 1, 16, 2, 8, generator=g).to(torch.bfloat16),
                "tok": torch.tensor(5, dtype=torch.int32), "hidden": torch.randn(8, generator=g)}}
        store = SynapseStore(warm_capacity_bytes=1, cold_dir={str(tmp_path)!r})
        store.put("a", snap)
        assert store.tier_of("a") == "cold"
        hdr = io.parse_frame_header(open(store._cold_path("a"), "rb").read())
        assert (hdr["codec"], hdr["hash_id"]) == (io.CODEC_ZLIB, io.HASH_CRC32)
        fresh = SynapseStore()
        assert fresh.recover(store.cold_dir)["recovered"] == ["a"]
        got = fresh.get_host("a")
        for k, v in snap.items():
            assert got[k].dtype == v.dtype and io.leaf_bytes(got[k]) == io.leaf_bytes(v)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg)
    params = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prism(params, cfg)
    prism = Prism(params, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CortexEngine(prism, ByteTokenizer(cfg.vocab_size), max_side=1, main_capacity=32)
    eng = CortexEngine(prism, ByteTokenizer(cfg.vocab_size), max_side=1, main_capacity=32, device="cpu")
    assert eng.device.type == "cpu" and eng.cfg.compute_dtype == "float32"


def test_serving_entry_points_raise_without_a_card(monkeypatch, capsys):
    """BatchServer and the launcher need the card unless asked for the CPU;
    asked, the launcher serves its requests there and returns the metrics."""
    from repro_torch.launch import serve
    from repro_torch.serving.server import BatchServer

    _no_card(monkeypatch)
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    params = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=1, capacity=32)
    srv = BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=1, capacity=32, device="cpu")
    assert srv.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "batch"])
    m = serve.main(["--mode", "batch", "--device", "cpu", "--max-new-tokens", "4", "--no-stream",
                    "--request", "t:0:hello"])
    assert m["completed"] == 1 and m["backend"] == "batch"
    assert "serving on cpu: 1 completed" in capsys.readouterr().out


def test_kernel_wrappers_refuse_non_cuda_devices():
    """On a CPU tensor the wrapper runs the plain version; any other device
    is refused, never routed to the plain version."""
    from repro_torch.kernels import landmark_score, synapse_attention

    q = torch.zeros((1, 4, 8), device="meta")
    k = torch.zeros((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        synapse_attention.synapse_attention(q, k, k, torch.zeros((1, 16), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        landmark_score.landmark_score(q, k)


def test_chip_smoke_fails_fast_without_a_card():
    """``python3 chip_smoke.py`` on a machine without a card exits non-zero
    within seconds, saying so, and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "no CUDA device found" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repo, it fails."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and '"ok"' not in out.stdout
