"""The manifest against the contract it is written to, and every file a
name in it stands for found where ``pbharness.files`` looks."""

import importlib
import json
import re

import pytest
import torch

from pbharness import files, weights

BENCH = files.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank|_size|latent|state|expand|headdim|"
                   r"d_model|experts_per_tok)$")


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s a cell to compile and 1,200 s spare, inside 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in files.end_to_end_metrics(w["name"], BENCH)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert files.per_layer_metrics(w["name"], BENCH)
        assert "mfu.prefill" in {m["name"] for m in
                                 files.per_layer_metrics(w["name"], BENCH)}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    wl = files.workload(w["name"])
    assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
    gen = files.load_module("generators",
                            files.traffic(w["traffic"])["generator"])
    assert callable(gen.make)
    limits = wl["check"]["limits"]
    precision = files.load_module("reference", "precision")
    assert wl["check"]["controls"]
    assert set(wl["check"]["controls"]) <= set(precision.CONTROLS)
    for st in wl["check"].get("stages", []):
        stage = files.load_module("stages", st["name"])
        assert set(stage.NUMBERS) <= set(limits)
        mod, attr = stage.SPAN.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(mod), attr))
    assert wl["check"]["mode"] in ("logits", "layers")
    assert limits["token_mismatch"] == 0       # exact: the limit is 0
    assert all(v >= 0 for v in limits.values())
    assert wl["why"] == w["why"]
    for m in files.per_layer_metrics(w["name"], BENCH):
        reader = files.load_module("metrics", m["name"])
        assert callable(reader.read)
        for path in reader.SPANS:   # each span is an attribute of the port
            mod, attr = path.rsplit(".", 1)
            assert path.startswith("repro_torch.")
            assert callable(getattr(importlib.import_module(mod), attr))
    for m in files.end_to_end_metrics(w["name"], BENCH):
        assert callable(files.load_module("end_to_end", m["name"]).read)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    conf = files.read_json(files.ROOT / c["file"])
    assert conf == files.config(c["name"])
    assert conf["source"] == c["source"]
    assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for key, change in conf["reduced"].items():
        assert conf["published"][key] == change["published"] != change["run"]
        assert not WIDTH.search(key) or key == "vocab_size"
    assert conf["departures"] and conf["assumed"] and conf["deployment"]
    files.load_module("reference", conf["family"])
    from repro_torch import models
    cfg = models.LMConfig(**conf["lm_config"])
    # every leaf of the program's tree is covered by an init rule
    for path, leaf in weights.leaves(models.init_abstract(cfg)):
        weights.rule_for(path, conf["init"])


def test_published_widths_are_the_run_widths():
    phi = files.config("phi3.5-moe")
    p, r = phi["published"], phi["lm_config"]
    assert (r["d_model"], r["d_ff"], r["n_heads"], r["n_kv_heads"],
            r["n_experts"], r["moe_top_k"], r["vocab_size"]) == (
        p["hidden_size"], p["intermediate_size"], p["num_attention_heads"],
        p["num_key_value_heads"], p["num_local_experts"],
        p["num_experts_per_tok"], p["vocab_size"])
    assert r["n_layers"] == phi["reduced"]["num_hidden_layers"]["run"]
    mamba = files.config("mamba2-780m")
    p, r = mamba["published"], mamba["lm_config"]
    assert (r["d_model"], r["n_layers"], r["ssm_state"], r["ssm_head_dim"],
            r["ssm_expand"], r["ssm_chunk"]) == (
        p["d_model"], p["n_layer"], p["d_state"], p["headdim"], p["expand"],
        p["chunk_size"])
    pad = p["pad_vocab_size_multiple"]
    assert r["vocab_size"] == -(-p["vocab_size"] // pad) * pad


def test_weights_one_draw_a_rule_and_repeatable():
    from repro_torch import models
    conf = files.config("mamba2-780m")
    lc = dict(conf["lm_config"], n_layers=2, d_model=32, vocab_size=64,
              ssm_state=8, ssm_head_dim=8, ssm_chunk=8)
    abstract = models.init_abstract(models.LMConfig(**lc))
    a, plan = weights.make(abstract, conf["init"], 2 ** 31 + 12345, "cpu")
    b, _ = weights.make(abstract, conf["init"], 2 ** 31 + 12345, "cpu")
    c, _ = weights.make(abstract, conf["init"], 7, "cpu")
    # one draw a rule and dtype
    assert len(plan) == len({(weights.rule_for(p, conf["init"]), t.dtype)
                             for p, t in weights.leaves(abstract)})
    for (pa, ta), (_, tb), (_, tc) in zip(weights.leaves(a), weights.leaves(b),
                                          weights.leaves(c)):
        assert ta.dtype == dict(weights.leaves(abstract))[pa].dtype
        assert torch.equal(ta, tb)
        if pa.endswith("scale") or pa.endswith("d_skip"):
            assert bool((ta == 1).all())
        elif ta.numel() > 8:
            assert not torch.equal(ta, tc), pa
        base = ta.untyped_storage().data_ptr()
        assert (ta.data_ptr() - base) % weights.ALIGN == 0
    a_log = a["layers"]["ssm"]["a_log"]
    assert bool(((a_log >= 0) & (a_log <= torch.log(torch.tensor(16.0)))).all())


def test_column_scale_multiplies_each_column_of_a_rules_leaves():
    from repro_torch import models
    conf = files.config("phi3.5-moe")
    lc = dict(conf["lm_config"], n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_head=16, d_ff=32, vocab_size=64, n_experts=4)
    abstract = models.init_abstract(models.LMConfig(**lc))
    rules = [dict(r) for r in conf["init"]]
    scale = [1.0, 2.0, 0.5, 0.0]
    rules.insert(0, {"leaves": ["layers/moe/router"], "dist": "normal",
                     "std": 0.02, "column_scale": scale})
    a, _ = weights.make(abstract, conf["init"], 2 ** 31 + 5, "cpu")
    b, _ = weights.make(abstract, rules, 2 ** 31 + 5, "cpu")
    ra, rb = a["layers"]["moe"]["router"].float(), b["layers"]["moe"]["router"].float()
    assert ra.shape[-1] == len(scale)
    assert torch.equal(rb, (ra * torch.tensor(scale)).to(rb.dtype).float())
    assert torch.equal(a["embed"], b["embed"])
