"""Tiny stand-ins of the benchmark's configurations and cells for the CPU
tests: the published files with the widths and depth cut, run through
the real harness with its file lookups pointed at them."""

import copy

from pbharness import files

TINY_LM = {
    "phi3.5-moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=96, vocab_size=256, n_experts=4),
    "mamba2-780m": dict(n_layers=8, d_model=64, vocab_size=256, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=8),
}
CELLS = {"phi3.5-moe": "phi35moe.prefill-4k", "mamba2-780m": "mamba2.prefill-4k"}


def tiny_conf(name: str) -> dict:
    conf = copy.deepcopy(files.config(name))
    conf["lm_config"].update(TINY_LM[name])
    conf["vocab_draw"] = conf["lm_config"]["vocab_size"]
    return conf


def tiny_mix(batch=2, seq_len=48) -> dict:
    return {"generator": "closed_prefill", "batch": batch,
            "seq_len": seq_len, "warmup_steps": 1, "trace_steps": 2}


def point_at_tiny(monkeypatch, name: str, mix=None, limits=None):
    """Make the harness read the tiny configuration ``name``, the tiny mix
    and the real cell's check (its limits unless ``limits`` are given);
    returns the cell's name."""
    cell = CELLS[name]
    wl = copy.deepcopy(files.workload(cell))
    wl["check"]["sample_steps"] = 2
    if limits is not None:
        wl["check"]["limits"] = limits
    conf, mix = tiny_conf(name), mix or tiny_mix()
    monkeypatch.setattr(files, "config", lambda n: conf)
    monkeypatch.setattr(files, "traffic", lambda n: mix)
    monkeypatch.setattr(files, "workload", lambda n: wl)
    return cell
