"""The check that decides ``correct``, driven through a whole run on the CPU
at a small size: the program passes; the control (the reference at fp8 in
the program's place) and each fault planted under the timed path fail."""
import json
from pathlib import Path

import pytest
import torch

from cortex_bench import harness
from cortex_bench.run import verdict_lines

LIMITS = Path(__file__).resolve().parents[1] / "limits"

SMALL = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2, "d_head": 32, "d_ff": 256, "vocab_size": 512}
MIX = {"engine": {"n_main": 2, "max_side": 4, "main_capacity": 512, "sync_every": 4, "max_window": 16,
                  "side_max_steps": 12, "inject_tokens": 16, "theta": -1.0},
       "tags": {"share": 1.0, "count": [2, 2], "words": [3, 8]}, "preamble_bytes": {"lo": 40, "hi": 90},
       "river_margin": 200, "max_new_tokens": [10, 10], "queue_depth": 2}


def small_run(control=False, seconds=2.0, seed=5):
    res = harness.run("qwen25-council", seed, seconds, False, device="cpu", control=control,
                     overrides={"model": SMALL, "mix": MIX}, log=lambda *a: None)
    assert res["verdict"] is not None, "no request finished"
    return res["verdict"]


def limits():
    return json.loads((LIMITS / "qwen25-council.json").read_text())["limits"]


def test_program_passes_and_control_fails():
    v = small_run(control=True)
    ok, _ = verdict_lines(v["numbers"], limits())
    assert ok, v["numbers"]
    bad, checks = verdict_lines(v["control"], limits())
    assert not bad, checks
    assert v["tokens_judged"] > 0


def _unchanged_state(mp):
    # the river's decode writes nothing into its cache: its state is unchanged
    from repro_torch.models import attention
    mp.setattr(attention, "masked_lane_write", lambda buf, slot, val, ok: None)


def _half_batch(mp):
    # the decode computes half of its lanes: each odd lane takes the logits
    # of the even lane before it (every request's two sides sit in one pair)
    from repro_torch.models import model
    real = model.decode_step

    def half(params, cfg, inputs, caches, *, spec):
        logits, hidden, caches = real(params, cfg, inputs, caches, spec=spec)
        lanes = torch.arange(logits.shape[0], device=logits.device)
        return logits[lanes - lanes % 2], hidden, caches
    mp.setattr(model, "decode_step", half)


def _token_altered(mp):
    # every fifth tick, each lane's sampled token is changed where it is produced
    from repro_torch.core import engine
    real, calls = engine.sample_lanes, [0]

    def altered(*a, **k):
        out = real(*a, **k)
        calls[0] += 1
        return (out + 1) % 256 if calls[0] % 5 == 0 else out
    mp.setattr(engine, "sample_lanes", altered)


def _pick_altered(mp):
    # a spawn's landmark pick is changed where it is produced
    from repro_torch.core import synapse
    real = synapse.select_landmarks

    def altered(*a, **k):
        idx, score, ok = real(*a, **k)
        return torch.where(idx > 0, idx - 1, idx + 1), score, ok
    mp.setattr(synapse, "select_landmarks", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _token_altered, _pick_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_under_the_timed_path_fails(monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = verdict_lines(small_run()["numbers"], limits())
    assert not ok, checks
