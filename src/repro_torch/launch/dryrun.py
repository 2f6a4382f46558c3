"""Dry run: the per-rank program of every (arch × shape × mesh) cell on
the ``meta`` device, priced by a cost recorder (port of
``repro/launch/dryrun.py``).

For each cell the rank's program is built over the abstract production
mesh (``launch.mesh.make_production_mesh``: (16, 16) "single", (2, 16,
16) "multi"): ``init_abstract`` params and ``input_specs`` inputs, each
rank's blocks by the sharding tables (``dist.smap.put``), the MoE
expert-parallel (``MoEParallel("shard_map")``, FSDP over the batch axes
unless ``fsdp=0``), the layers' weights gathered at use.  The step runs
under ``obs.cost.CostRecorder``: FLOPs from ``FlopCounterMode`` plus the
kernels' own counts (B4-B8 take their ``meta`` route while the recorder
is active), bytes as every op's inputs and outputs (an upper bound like
XLA's "bytes accessed"), the peak of live tensor bytes, and the
collectives ``dist.smap`` logs (``launch.hlo_analysis``).  That a cell
runs at all proves the tables and the program agree at full width: a
kernel check that refuses a full-width per-rank shape makes the cell
``"error"`` with the check's own words.

The layer stack is a Python loop, so every layer is counted: the
reference's two-point probe (re-lowering with 1 and 2 unrolled layers
to undo XLA's count-once of a while-loop body) has no counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
Artifacts: artifacts/torch/dryrun/{arch}__{shape}__{mesh}.json (skip if
it exists, --force to redo).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, all_archs, get_arch, input_specs
from repro_torch.configs.base import ArchSpec
from repro_torch.dist import sharding as shd
from repro_torch.dist.ctx import sharding_rules
from repro_torch.dist.smap import put
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_abstract_mesh, make_production_mesh
from repro_torch.models import MoEParallel, init_abstract
from repro_torch.obs.cost import CostRecorder
from repro_torch.optim import make_optimizer
from repro_torch.train import (TrainState, make_decode_fn, make_prefill_step,
                               make_train_step)

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "dryrun"

VARIANT_KEYS = ("remat", "fsdp", "block_local", "seq_parallel", "ssm_chunk",
                "kv_quant", "pad_heads")


def apply_variant(arch: ArchSpec, variant: dict) -> ArchSpec:
    """Variant knobs for perf iterations (the reference's)."""
    cfg = arch.config
    if "remat" in variant:
        cfg = dataclasses.replace(cfg, remat=str(variant["remat"]))
    if variant.get("block_local"):
        cfg = dataclasses.replace(cfg, block_local_attn=True)
    if variant.get("seq_parallel"):
        cfg = dataclasses.replace(cfg, seq_parallel_attn=True)
    if variant.get("ssm_chunk"):
        cfg = dataclasses.replace(cfg, ssm_chunk=int(variant["ssm_chunk"]))
    if variant.get("kv_quant"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if variant.get("pad_heads"):
        ph = int(variant["pad_heads"])
        kv = max(1, ph * cfg.n_kv_heads // max(1, cfg.n_heads))
        cfg = dataclasses.replace(cfg, n_heads=ph, n_kv_heads=kv)
    return dataclasses.replace(arch, config=cfg)


def build_cell(arch: ArchSpec, shape_name: str, mesh, variant: dict = None,
               cfg=None):
    """The rank's program of a cell: ``(run, base)``, ``run()`` the step
    on the rank's ``meta`` blocks (under the mesh's sharding rules),
    ``base`` the tensors live before it (state and inputs).  ``cfg``
    overrides the arch's config (the tests' reduced configs)."""
    variant = variant or {}
    arch = apply_variant(arch, variant)
    if cfg is not None:
        arch = dataclasses.replace(arch, config=cfg)
    cfg = arch.config
    ss = SHAPES[shape_name]
    specs = input_specs(arch, shape_name)
    fsdp = bool(int(variant.get("fsdp", 1)))
    layout = "fsdp" if fsdp else "model"
    moe_par = None
    if cfg.is_moe:
        moe_par = MoEParallel(mode="shard_map", model_axis="model",
                              fsdp_axes=(shd.batch_axes(mesh) if fsdp
                                         else ()), mesh=mesh)
    params = put(init_abstract(cfg), shd.param_shardings(cfg, mesh, fsdp),
                 mesh)

    if ss.kind == "train":
        opt = make_optimizer(state_dtype=cfg.param_dtype)
        step, _ = make_train_step(cfg, opt, moe_parallel=moe_par)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device="meta"))
        batch = {"inputs": specs["inputs"], "labels": specs["labels"]}

        def run():
            with sharding_rules(mesh, param_layout=layout):
                return step(state, batch)
        return run, (state, batch)

    if ss.kind == "prefill":
        fn = make_prefill_step(cfg, moe_parallel=moe_par)
        inputs = put(specs["inputs"],
                     shd.prefill_shardings(cfg, mesh)["inputs"], mesh)

        def run():
            with sharding_rules(mesh, param_layout=layout):
                return fn(params, inputs)
        return run, (params, inputs)

    fn = make_decode_fn(cfg)
    state = put(specs["state"],
                shd.decode_state_shardings(cfg, mesh, ss.global_batch), mesh)
    tokens = put(specs["tokens"],
                 shd.decode_token_shardings(cfg, mesh, ss.global_batch), mesh)

    def run():
        with sharding_rules(mesh, param_layout=layout):
            return fn(params, state, tokens)
    return run, (params, state, tokens)


def measure(run, base) -> dict:
    """Run ``run()`` under a ``CostRecorder``; its counts as a dict."""
    t0 = time.perf_counter()
    with CostRecorder(base=base) as rec:
        run()
    wire, coll = hlo_analysis.collective_summary(rec.collectives)
    return {"flops_per_device": float(rec.flops),
            "aten_flops_per_device": float(rec.flops - rec.kernel_flops),
            "bytes_per_device": float(rec.bytes),
            "peak_bytes": int(rec.peak_bytes),
            "base_bytes": int(rec.base_bytes),
            "kernels": rec.kernels,
            "collectives": coll,
            "collective_wire_bytes_per_device": wire,
            "wire_by_link": hlo_analysis.wire_by_link(rec.collectives),
            "trace_s": round(time.perf_counter() - t0, 3)}


def _mesh_for(mesh_kind: str):
    if mesh_kind == "single":
        return make_production_mesh()
    if mesh_kind == "multi":
        return make_production_mesh(multi_pod=True)
    # "DxM": a small abstract (data, model) mesh
    d, m = map(int, mesh_kind.split("x"))
    return make_abstract_mesh((d, m))


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             force: bool = False, variant: dict = None, tag: str = "",
             cfg=None, art_dir: Path = None, write: bool = True) -> dict:
    """One cell's record, written to ``art_dir`` (default
    ``artifacts/torch/dryrun``).  ``cfg`` overrides the arch's config
    (and then nothing is read from an earlier file)."""
    variant = variant or {}
    art_dir = ART_DIR if art_dir is None else Path(art_dir)
    suffix = f"__variant-{tag}" if tag else ""
    out_path = art_dir / f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json"
    if write and out_path.exists() and not force and cfg is None:
        return json.loads(out_path.read_text())

    arch = get_arch(arch_id)
    c = cfg or arch.config
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
              "variant": variant, "tag": tag, "config": c.name,
              "n_layers": c.n_layers, "params": c.param_count(),
              "active_params": c.active_param_count()}
    if not arch.shape_runnable(shape_name):
        result["status"] = "skipped"
        result["skip_reason"] = arch.skips[shape_name]
    else:
        mesh = _mesh_for(mesh_kind)
        try:
            run, base = build_cell(arch, shape_name, mesh, variant, cfg)
            result.update(measure(run, base))
            result["status"] = "ok"
            result["devices"] = mesh.size
        except Exception as e:
            result["status"] = "error"
            result["error"] = f"{type(e).__name__}: {e}"
            result["traceback"] = traceback.format_exc()[-4000:]
    if write:
        art_dir.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    help="single | multi | both | DxM")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="key=value perf-variant knobs (repeatable)")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    args = ap.parse_args(argv)
    variant = {}
    for kv in args.variant:
        k, _, v = kv.partition("=")
        variant[k] = v

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in sorted(all_archs()) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    n_ok = n_skip = n_err = 0
    for arch_id, shape_name in cells:
        for mk in meshes:
            r = run_cell(arch_id, shape_name, mk, force=args.force,
                         variant=variant, tag=args.tag)
            status = r["status"]
            if status == "ok":
                n_ok += 1
                print(f"[OK]   {arch_id:28s} {shape_name:12s} {mk:6s} "
                      f"trace={r['trace_s']:7.2f}s "
                      f"flops/dev={r['flops_per_device']:.3e} "
                      f"bytes/dev={r['bytes_per_device']:.3e} "
                      f"wire_B/dev={r['collective_wire_bytes_per_device']:.3e} "
                      f"peak={r['peak_bytes'] / 2**30:.2f}GiB", flush=True)
            elif status == "skipped":
                n_skip += 1
                print(f"[SKIP] {arch_id:28s} {shape_name:12s} {mk:6s}",
                      flush=True)
            else:
                n_err += 1
                print(f"[ERR]  {arch_id:28s} {shape_name:12s} {mk:6s} "
                      f"{r['error'][:160]}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
