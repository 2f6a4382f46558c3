"""The harness end to end on the CPU at a reduced size: the result line's
keys, the port agreeing with the reference, and ``correct`` coming out
false for each fault a prefill cell can have.  The chip look of
``run.py`` is skipped: ``core.run_cell`` is driven directly with the
program's CPU path."""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_tiny import CELLS, point_at_tiny
from pbharness import core, files

TIGHT = {"logits": {"logit_err_mean": 0.02, "logit_err_max": 0.03,
                    "token_gap_max": 0.5, "scan_err_max": 1e-4,
                    "token_mismatch": 0},
         "layers": {"embed_err_max": 0.0, "layer_err_median": 0.03,
                    "layer_err_mean": 0.05, "head_err_max": 0.02,
                    "moe_off_share": 0.0, "token_mismatch": 0}}


def run(cell, trace=False, seed=2 ** 31 + 77, seconds=0.2):
    return core.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["phi3.5-moe", "mamba2-780m"])
def test_port_agrees_with_the_reference_at_a_reduced_size(monkeypatch, name):
    torch.set_num_threads(2)
    mode = files.workload(CELLS[name])["check"]["mode"]
    cell = point_at_tiny(monkeypatch, name, limits=TIGHT[mode])
    r = run(cell)
    assert r["correct"], r["check"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(monkeypatch, traced):
    torch.set_num_threads(2)
    cell = point_at_tiny(monkeypatch, "phi3.5-moe")
    r = run(cell, trace=traced)
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for name, c in line["check"].items():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device in a CPU run: no device metric is reported
        assert line["metrics"] == {}
    else:
        want = {m["name"] for m in files.end_to_end_metrics(cell)}
        assert set(line["metrics"]) == want
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]


def _fault_state_unchanged(monkeypatch):
    from repro_torch import models
    monkeypatch.setattr(models, "forward", lambda params, cfg, ids: (
        params["embed"].to(cfg.adtype)[ids], None))


def _fault_half_batch(monkeypatch):
    from repro_torch import models
    forward = models.forward

    def half(params, cfg, ids):
        h, aux = forward(params, cfg, ids[: ids.shape[0] // 2])
        rest = h.mean(dim=0, keepdim=True).expand(ids.shape[0] - h.shape[0],
                                                  *h.shape[1:])
        return torch.cat([h, rest]), aux
    monkeypatch.setattr(models, "forward", half)


def _fault_answer_altered(monkeypatch):
    from repro_torch import models
    logits_fn = models.logits_fn

    def altered(params, cfg, hidden):
        out = logits_fn(params, cfg, hidden).clone()
        out[0] = out[0].roll(1)
        return out
    monkeypatch.setattr(models, "logits_fn", altered)


def _fault_token_altered(monkeypatch):
    step = core.Session.step

    def altered(self, ids):
        tokens, logits = step(self, ids)
        tokens[-1] = (tokens[-1] + 1) % logits.shape[-1]
        return tokens, logits
    monkeypatch.setattr(core.Session, "step", altered)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch,
          "answer_altered": _fault_answer_altered,
          "token_altered": _fault_token_altered}


@pytest.mark.parametrize("name", ["phi3.5-moe", "mamba2-780m"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_comes_out_not_correct(monkeypatch, name, fault):
    """With the real cell's limits: the sound run is correct, the run with
    the timed path broken underneath is not."""
    torch.set_num_threads(2)
    cell = point_at_tiny(monkeypatch, name)
    assert run(cell, seed=5)["correct"]
    FAULTS[fault](monkeypatch)
    r = run(cell, seed=5)
    assert not r["correct"], r["check"]


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(files.BENCH_DIR / "run.py"),
                        "--workload", "mamba2.prefill-4k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=files.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # a checkout holding only the manifest and the benchmark's files
    bare = tmp_path / "bare"
    shutil.copytree(files.BENCH_DIR, bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(files.MANIFEST, bare / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "mamba2.prefill-4k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, cwd=bare, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_traffic_is_drawn_from_the_seed():
    from pbharness import traffic
    mix = {"generator": "closed_prefill", "batch": 2, "seq_len": 16}
    a = traffic.load(mix, 2 ** 31 + 3, 100, "cpu")
    b = traffic.load(mix, 2 ** 31 + 3, 100, "cpu")
    c = traffic.load(mix, 2 ** 31 + 4, 100, "cpu")
    assert torch.equal(a.prompts(5), b.prompts(5))
    assert not torch.equal(a.prompts(5), a.prompts(6))
    assert not torch.equal(a.prompts(5), c.prompts(5))
    assert not torch.equal(a.prompts(0), a.prompts(0, traffic.WARMUP_STREAM))
    p = a.prompts(1)
    assert p.shape == (2, 16) and int(p.min()) >= 0 and int(p.max()) < 100


def test_mixed_lengths_are_one_set_in_an_order_of_the_seed():
    from pbharness import traffic
    mix = {"generator": "closed_prefill", "batch": 1, "warmup_steps": 1,
           "lengths": {"median": 64, "sigma": 1.0, "min": 16, "max": 256,
                       "count": 8, "multiple": 16}}
    a = traffic.load(mix, 2 ** 31 + 5, 100, "cpu")
    c = traffic.load(mix, 2 ** 31 + 6, 100, "cpu")
    la = [a.shape(i)[1] for i in range(8)]
    lc = [c.shape(i)[1] for i in range(8)]
    assert sorted(la) == sorted(lc) == sorted(a.lengths) and la != lc
    assert all(16 <= n <= 256 and n % 16 == 0 for n in la)
    assert len(set(la)) > 3
    assert [a.shape(i) for i in range(8, 16)] == [a.shape(i) for i in range(8)]
    assert a.prompts(3).shape == a.shape(3)
    # set-up runs every length the window will use
    assert {tuple(t.shape) for t in a.warmup()} == {a.shape(i)
                                                    for i in range(8)}


def test_a_run_with_mixed_lengths_is_correct(monkeypatch):
    torch.set_num_threads(2)
    mix = {"generator": "closed_prefill", "batch": 1, "warmup_steps": 1,
           "trace_steps": 2,
           "lengths": {"median": 32, "sigma": 0.7, "min": 16, "max": 64,
                       "count": 3, "multiple": 8}}
    cell = point_at_tiny(monkeypatch, "phi3.5-moe", mix=mix,
                         limits=TIGHT["layers"])
    r = run(cell, trace=True)
    assert r["correct"], r["check"]


def test_sample_is_drawn_from_the_seed():
    assert core.sample(40, 6, 9) == core.sample(40, 6, 9)
    assert core.sample(40, 6, 9) != core.sample(40, 6, 10)
    assert core.sample(3, 6, 9) == [0, 1, 2]
