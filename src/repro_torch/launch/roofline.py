"""Roofline analysis of the port's dry-run files, priced for the H100
(port of ``repro/launch/roofline.py``).

Per (arch x shape), from ``artifacts/torch/dryrun/`` (``launch.dryrun``):
  compute term    = FLOPs a device / PEAK_FLOPS_BF16 (989e12)      [s]
  memory term     = bytes a device / HBM_BANDWIDTH (3.35e12)       [s]
  collective term = wire bytes a device / the link of each group:
                    NVLINK_BANDWIDTH inside an 8-GPU node, the node
                    link (NODE_LINK_BANDWIDTH) across nodes        [s]

plus MODEL_FLOPS (6*N*D train / 2*N*D prefill / 2*N*B decode, N = active
params for MoE), the useful-compute ratio MODEL_FLOPS / counted FLOPs
(catches remat and replicated-compute waste), the dominant term, the
peak live bytes against HBM_BYTES, and a roofline fraction
  = (MODEL_FLOPS time) / dominant term
— the score an ideal kernel and sharding would push toward 1.0.

The counts are the per-rank program's on the ``meta`` device
(``obs.cost.CostRecorder``): FLOPs of every aten op plus each kernel's
own count, bytes an upper bound (each op's inputs and outputs), the
collectives as ``dist.smap`` logs them.  Constants: NVIDIA H100 80GB
HBM3, 700.00 W (``launch.mesh``).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
Writes artifacts/torch/roofline.md + artifacts/torch/roofline.json.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import SHAPES, all_archs
from repro_torch.launch.mesh import (HBM_BANDWIDTH, HBM_BYTES,
                                     NODE_LINK_BANDWIDTH, NVLINK_BANDWIDTH,
                                     PEAK_FLOPS_BF16)

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch"


def step_flops(cfg, kind: str, batch: int, seq_len: int) -> float:
    """The 6 N D (train) / 2 N D (prefill, decode) convention for one
    step of ``kind`` over ``batch`` sequences of ``seq_len`` tokens, N the
    active parameters: a prefill is credited every position's LM-head
    product, though ``make_prefill_step`` computes only the last one's."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq_len
    if kind == "prefill":
        return 2.0 * n * batch * seq_len
    return 2.0 * n * batch      # decode: one token per sequence


def model_flops(arch, shape_name: str) -> float:
    ss = SHAPES[shape_name]
    return step_flops(arch.config, ss.kind, ss.global_batch, ss.seq_len)


def decode_ideal_bytes(arch, shape_name: str) -> float:
    """Ideal HBM traffic for one decode step: every active parameter read
    once (bf16) + the visible KV cache read once — the bandwidth floor that
    defines decode roofline."""
    cfg = arch.config
    ss = SHAPES[shape_name]
    param_bytes = 2.0 * cfg.active_param_count()
    kv_bytes = 0.0
    if cfg.has_attn:
        windows = list(cfg.window_pattern) or [0]
        reps = (cfg.n_layers + len(windows) - 1) // len(windows)
        per_layer = (windows * reps)[: cfg.n_layers]
        for w in per_layer:
            vis = min(ss.seq_len, w) if w > 0 else ss.seq_len
            kv_bytes += (2 * ss.global_batch * vis * cfg.n_kv_heads
                         * cfg.d_head * 2.0)
    if cfg.has_ssm:
        sd = cfg.ssm_dims
        kv_bytes += (ss.global_batch * sd.n_heads * sd.head_dim
                     * sd.d_state * 4.0 * cfg.n_layers)
    return param_bytes + kv_bytes


def suggest(dom: str, arch, shape_name: str) -> str:
    """The next Hopper lever for a cell's dominant term."""
    ss = SHAPES[shape_name]
    if dom == "collective":
        if arch.config.is_moe:
            return ("shrink the expert-FSDP all-gather: shard experts over "
                    "more axes or keep gathered slabs across microbatches")
        if ss.kind == "decode":
            return ("drop FSDP for decode (weights fit replicated per model "
                    "shard) to remove the per-token weight all-gathers")
        return ("overlap the FSDP all-gather with the previous layer "
                "(NCCL on a side stream) or keep gathers inside a node")
    if dom == "memory":
        if ss.kind == "decode":
            return ("decode reads the cache by nature: an int8 KV cache or "
                    "more sequences a step")
        return ("fuse the elementwise chains (norm, RoPE, SwiGLU) into GEMM "
                "epilogues; less remat recompute")
    return ("compute-bound: split the dense matmuls over the model axis "
            "(tensor parallel), keep bf16 on wgmma, no float32 upcasts")


def _collective_s(r: dict) -> float:
    by = r.get("wire_by_link") or {
        "node": r.get("collective_wire_bytes_per_device", 0.0)}
    return (by.get("nvlink", 0.0) / NVLINK_BANDWIDTH
            + by.get("node", 0.0) / NODE_LINK_BANDWIDTH)


def analyze(mesh_kind: str = "single", art: Path = None):
    art = ART if art is None else Path(art)
    rows = []
    for arch_id, arch in sorted(all_archs().items()):
        for shape_name in SHAPES:
            p = art / "dryrun" / f"{arch_id}__{shape_name}__{mesh_kind}.json"
            if not p.exists():
                continue
            r = json.loads(p.read_text())
            if r["status"] == "skipped":
                rows.append({"arch": arch_id, "shape": shape_name,
                             "status": "skipped"})
                continue
            if r["status"] != "ok":
                rows.append({"arch": arch_id, "shape": shape_name,
                             "status": "error", "error": r.get("error")})
                continue
            chips = r["devices"]
            fl_dev = r["flops_per_device"]
            by_dev = r["bytes_per_device"]
            t_comp = fl_dev / PEAK_FLOPS_BF16
            t_mem = by_dev / HBM_BANDWIDTH
            t_coll = _collective_s(r)
            mf = model_flops(arch, shape_name)
            ss = SHAPES[shape_name]
            if ss.kind == "decode":
                # decode is bandwidth-limited: ideal = params+cache once
                t_useful = (decode_ideal_bytes(arch, shape_name)
                            / (chips * HBM_BANDWIDTH))
            else:
                t_useful = mf / (chips * PEAK_FLOPS_BF16)
            dom = max((t_comp, "compute"), (t_mem, "memory"),
                      (t_coll, "collective"))[1]
            t_dom = max(t_comp, t_mem, t_coll)
            rows.append({
                "arch": arch_id, "shape": shape_name, "status": "ok",
                "chips": chips,
                "flops_per_device": fl_dev, "bytes_per_device": by_dev,
                "wire_bytes_per_device":
                    r.get("collective_wire_bytes_per_device", 0.0),
                "peak_bytes": r["peak_bytes"],
                "peak_over_hbm": r["peak_bytes"] / HBM_BYTES,
                "t_compute_s": t_comp, "t_memory_s": t_mem,
                "t_collective_s": t_coll, "dominant": dom,
                "model_flops": mf,
                "counted_flops_global": fl_dev * chips,
                "useful_ratio": mf / max(1.0, fl_dev * chips),
                "roofline_fraction": t_useful / max(1e-12, t_dom),
                "suggestion": suggest(dom, arch, shape_name),
            })
    return rows


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | FLOPs/dev | bytes/dev | wire B/dev | peak/HBM "
           "| compute s | memory s | collective s | dominant | useful ratio "
           "| roofline frac | next lever |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                       f"| — | — | {r['status']} | — | — | — |\n")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['flops_per_device']:.3e} | "
            f"{r['bytes_per_device']:.3e} | "
            f"{r['wire_bytes_per_device']:.3e} | "
            f"{r['peak_over_hbm']:.2f} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['suggestion'][:60]} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = analyze(args.mesh)
    ART.mkdir(parents=True, exist_ok=True)
    (ART / "roofline.json").write_text(json.dumps(rows, indent=2))
    md = to_markdown(rows)
    (ART / "roofline.md").write_text(md)
    print(md)
    ok = [r for r in rows if r["status"] == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        coll = max(ok, key=lambda r: r["t_collective_s"] /
                   max(1e-12, max(r["t_compute_s"], r["t_memory_s"])))
        print(f"\nworst roofline fraction: {worst['arch']} {worst['shape']} "
              f"({worst['roofline_fraction']:.3f})")
        print(f"most collective-bound:   {coll['arch']} {coll['shape']}")
    return rows


if __name__ == "__main__":
    main()
