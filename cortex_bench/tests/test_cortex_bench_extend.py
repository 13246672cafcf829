"""A configuration, a cell, a mix and a metric are added as files and entries
alone (here an open-loop mix in bursts from two tenants); a run loads nothing of JAX or of the JAX package; and
without a card the command fails rather than reporting."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from cortex_bench import harness, run
res = harness.run("qwen25-throwaway", 3, 2.0, False, device="cpu", log=lambda *a: None)
bench = harness.load_bench()
got = {m["name"]: run.reader(m["name"])(res["data"]) for m in run.cell_metrics(bench, "qwen25-throwaway", False)}
got["ttft_p95_ms"] = run.reader("ttft_p95_ms")(res["data"])
print(json.dumps({"metrics": got, "forbidden": run.forbidden_modules(),
                  "tags": sorted({r["tags"] for r in res["data"].requests}), "judged": res["verdict"]["requests_judged"],
                  "tenants": sorted({r["tenant"] for r in res["data"].requests})}))
"""


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src")
    return e


def test_new_mix_cell_and_metric_are_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "cortex_bench", tmp_path / "cortex_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration (a small model with per-head q/k norms and its own
    # head), an open-loop mix in bursts from two tenants, a cell and a metric
    conf = json.loads((ROOT / "cortex_bench" / "configs" / "qwen2.5-0.5b.json").read_text())
    conf["model"].update(name="throwaway", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
                         vocab_size=512, qkv_bias=False, qk_norm=True, tie_embeddings=False)
    (tmp_path / "cortex_bench" / "configs" / "throwaway.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "throwaway", "source": "https://example.org/throwaway",
                             "file": "cortex_bench/configs/throwaway.json", "reduced": [], "why": "a test's"})
    mix = {"loop": "open", "rate_per_s": 4.0, "burst": 2, "pool": 4, "preamble_bytes": {"lo": 40, "hi": 60},
           "tenants": {"a": {"weight": 3.0, "share": 0.5}, "b": {"weight": 1.0, "share": 0.5}},
           "tags": {"share": 1.0, "count": [1, 1], "words": [3, 4]}, "max_new_tokens": [6, 6], "river_margin": 200,
           "engine": {"n_main": 2, "max_side": 2, "main_capacity": 512, "sync_every": 4, "max_window": 8,
                      "side_max_steps": 6, "inject_tokens": 16, "theta": -1.0}}
    (tmp_path / "cortex_bench" / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (tmp_path / "cortex_bench" / "metrics" / "finished.throwaway.py").write_text(
        "def read(d):\n    return sum(r['status'] == 'ok' for r in d.requests)\n")
    bench["workloads"].append({"name": "qwen25-throwaway", "config": "throwaway", "traffic": "throwaway",
                               "chips": 1, "why": "a test's throwaway cell"})
    bench["end_to_end"].append({"name": "finished.throwaway", "unit": "requests", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["qwen25-throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path), str(ROOT / "src")], cwd=tmp_path,
                         env=env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert got["tags"] == [1] and got["judged"] >= 1 and got["tenants"] == ["a", "b"]
    assert got["metrics"]["finished.throwaway"] >= 1 and got["metrics"]["agent_tokens_per_s"] > 0
    assert got["metrics"]["ttft_p95_ms"] > 0  # the open loop's arrivals came from their own thread


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "cortex_bench/run.py", "--workload", "qwen25-council", "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
