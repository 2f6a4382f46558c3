#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all in parallel), then:

  1. holds the timeline verdict-reduction kernel against its plain
     PyTorch version on the card, at the main path's chunk shape
     (4,096 scenarios x 240 steps x 7 tiers), with crossing edge cases;
  2. holds the ELL propagation kernel against its plain version on the
     card, on the paper-scale call graph (21,979 services) and the main
     path's dark sets plus the all-preemptible worst case, and on the
     same fleet with multi-hop fail-close relay chains
     (``unsafe_chain_fraction=0.3``), where the fixed point takes more
     than 2 rounds and the round count tests the kernel's double
     buffering;
  3. runs the main path, ``SweepEngine(device="cuda").run``, on the
     paper-scale fleet over 65,536 scenarios (16 chunks of 4,096) with
     the dependency and cascade-storm stages, checks that both kernels
     were launched in that run, holds the first 4,096 scenarios against
     the port's own CPU run, and times cold and warm runs.

Grades: booleans, int32 counts, min/max and first-crossing outputs
exact; float verdicts float32-tight (rtol 1e-6); the availability
integral and mean, float32 sums in another order, rtol 3e-6 (kernel) and
1e-5 (engine).  Any failure exits non-zero.  The last two lines of
standard output are a JSON object of the kernels' numbers and the JSON
result line; without a CUDA device the script exits 2 and prints no
result.  It takes no arguments: the fleet, the grid and the number of
warm runs are fixed, so every passing run is the full-size one.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

THRESH = 0.999
F32_TIGHT = 1e-6
AVAIL_INT_RTOL = 3e-6
AVAIL_MEAN_RTOL = 1e-5

SCENARIOS = 65_536          # 16 chunks of 4,096
WARM_RUNS = 3
RELAY_CHAIN_FRACTION = 0.3  # multi-hop case of phase 2


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card: CUDA events around
    ``reps`` calls after ``warmup`` calls, synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: dict, want: dict, rtol_for: dict, where: str) -> float:
    """Two-grade comparison of host arrays; returns the largest absolute
    difference over finite float entries."""
    check(set(got) == set(want), f"{where}: keys differ "
          f"{sorted(set(got) ^ set(want))}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{where}: {k} is {g.dtype}{g.shape}, want {w.dtype}{w.shape}")
        if w.dtype.kind != "f":
            bad = int(np.count_nonzero(g != w))
            check(bad == 0, f"{where}: {k} differs in {bad} entries")
            continue
        fin = np.isfinite(w)
        check(np.array_equal(np.isfinite(g), fin)
              and np.array_equal(g[~fin], w[~fin]),
              f"{where}: {k} non-finite entries differ")
        d = np.abs(g[fin].astype(np.float64) - w[fin].astype(np.float64))
        if d.size:
            worst = max(worst, float(d.max()))
        rtol = rtol_for.get(k, 0.0)
        lim = rtol * np.abs(w[fin].astype(np.float64))
        over = int(np.count_nonzero(d > lim))
        check(over == 0, f"{where}: {k} differs beyond rtol={rtol} in "
              f"{over} entries (max abs {d.max():.3g})")
    return worst


# ---------------------------------------------------------------------------
# phase 1: the timeline verdict-reduction kernel
# ---------------------------------------------------------------------------


def reduce_inputs(seed: int, S: int, T: int, R: int):
    """Engine-like series from a seed, with hand-set crossing rows."""
    rng = np.random.default_rng(seed)
    avail = (0.999 + 0.001 * rng.random((S, T))).astype(np.float32)
    util = (rng.random((S, T)) * 1.2).astype(np.float32)
    cloud = (rng.random((S, T)) * 2e4 - 1e3).astype(np.float32)
    frac = (0.996 + 0.006 * rng.random((S, T, R))).astype(np.float32)
    frac[0] = 1.0                        # never below
    frac[1, 0] = 0.5                     # below at t=0, back at t=1
    frac[1, 1:] = 1.0
    frac[2, T // 2:, 0] = 0.5            # below from the middle to the end
    frac[2, :T // 2, 0] = 1.0
    frac[3, :, 1] = 1.0
    frac[3, -1, 1] = 0.5                 # below at the last step only
    frac[4, :40, 2] = 1.0                # crossing across a 32-step window
    frac[4, 30:33, 2] = 0.5
    frac[4, 33:, 2] = 1.0
    ts = (np.arange(T) * (7200.0 / T)).astype(np.float32)
    return avail, util, cloud, frac, ts


def phase_reduce(torch, device, S=4096, T=240, R=7) -> dict:
    from repro_torch.kernels.ufa import reduce as red
    host = reduce_inputs(12, S, T, R)
    args = [torch.from_numpy(a).to(device) for a in host]
    got = red.timeline_reduce(*args, thresh=THRESH)
    want = red.ref_timeline_reduce(*args, thresh=THRESH)
    if device.type == "cuda":
        torch.cuda.synchronize()
    to_np = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
    got, want = to_np(got), to_np(want)
    err = compare(got, want, {"avail_int": AVAIL_INT_RTOL}, "reduce")
    check(np.isinf(got["restore_t"][0]).all() and not got["below_seen"][0].any(),
          "reduce: never-below row")
    check((got["restore_t"][1] == host[4][1]).all(), "reduce: t=0 crossing")
    check(got["below_seen"][2, 0] and np.isinf(got["restore_t"][2, 0]),
          "reduce: never-restored tier")
    check(got["restore_t"][4, 2] == host[4][33], "reduce: window crossing")
    entry = {"name": "timeline_reduce", "route": "cuda",
             "source": "src/repro_torch/csrc/timeline_reduce.cu",
             "replaces": "src/repro/kernels/ufa/reduce.py:79",
             "max_abs_err": err}
    bytes_moved = (3 * S * T + S * T * R + T) * 4 + S * (4 * 4 + R * 5)
    ops = S * T * (5 + 2 * R)
    entry["bound_by"] = ("bytes" if bytes_moved / MEM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations")
    entry["bound_ms"] = 1e3 * max(bytes_moved / MEM_BYTES_PER_S,
                                  ops / F32_OPS_PER_S)
    if device.type == "cuda":
        # three input sets in turn (3 x 39 MB > the 50 MB L2), so each
        # timed launch reads its inputs from device memory
        sets = itertools.cycle(
            [args] + [[a.clone() for a in args] for _ in range(2)])
        entry["ms"] = device_ms(torch, lambda: red.timeline_reduce(
            *next(sets), thresh=THRESH), reps=60)
        entry["plain_ms"] = device_ms(torch, lambda: red.ref_timeline_reduce(
            *next(sets), thresh=THRESH), reps=10)
    entry["library_ms"] = None
    return entry


# ---------------------------------------------------------------------------
# phase 2: the ELL propagation kernel
# ---------------------------------------------------------------------------


def hold_propagation(torch, device, consts, dark: np.ndarray, where: str):
    """Kernel vs plain version on one dark batch: ``broken`` and
    ``rounds`` exact.  Returns the dark tensor, the rounds and the host
    ``broken`` matrix."""
    from repro_torch.kernels.ufa import propagation as prop
    dark_d = torch.from_numpy(dark).to(device)
    got, rounds = prop.fixed_point_ell(dark_d, consts["ell_dst"],
                                       consts["ell_closed"])
    want, ref_rounds = prop.ref_fixed_point(dark_d, consts["ell_dst"],
                                            consts["ell_closed"])
    got, want = got.cpu().numpy(), want.cpu().numpy()
    check(rounds == ref_rounds, f"{where}: rounds {rounds} != {ref_rounds}")
    bad = int(np.count_nonzero(got != want))
    check(bad == 0, f"{where}: broken differs in {bad} entries")
    check((got >= dark).all() and got.sum() > dark.sum(),
          f"{where}: the fixed point must contain the dark sets and "
          "break more")
    log(f"{where}: U={dark.shape[0]} n={dark.shape[1]} "
        f"K={consts['ell_dst'].shape[1]} rounds={rounds} "
        f"broken={int(got.sum())} dark={int(dark.sum())}")
    return dark_d, rounds, got


def phase_propagation(torch, device, graph, dark: np.ndarray) -> dict:
    from repro_torch.graph.propagation import edge_consts
    from repro_torch.kernels.ufa import propagation as prop
    consts = edge_consts(graph, device)
    dark_d, rounds, _ = hold_propagation(torch, device, consts, dark,
                                         "propagation")
    U, n = dark.shape
    K = consts["ell_dst"].shape[1]
    entry = {"name": "fixed_point_ell", "route": "cuda",
             "source": "src/repro_torch/csrc/fixed_point_ell.cu",
             "replaces": "src/repro/kernels/ufa/propagation.py:115",
             "max_abs_err": 0.0}
    # per round: the dark slab and the adjacency read, the new slab written
    bytes_moved = rounds * (2 * U * n + n * K * 5 + 4)
    ops = rounds * U * n * K * 2
    entry["bound_by"] = ("bytes" if bytes_moved / MEM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations")
    entry["bound_ms"] = 1e3 * max(bytes_moved / MEM_BYTES_PER_S,
                                  ops / F32_OPS_PER_S)
    if device.type == "cuda":
        args = (dark_d, consts["ell_dst"], consts["ell_closed"])
        entry["ms"] = device_ms(torch, lambda: prop.fixed_point_ell(*args),
                                reps=20)
        entry["plain_ms"] = device_ms(
            torch, lambda: prop.ref_fixed_point(*args), reps=5)
        # one round alone, launched back to back without the host's read
        # of the changed flag: the kernel's own time per round
        cur = dark_d.clone()
        nxt = torch.empty_like(cur)
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        launch = prop._lib()
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (cur.data_ptr(), nxt.data_ptr(),
                consts["ell_dst"].data_ptr(),
                consts["ell_closed"].data_ptr(), U, n, K, flag.data_ptr(),
                stream)
        round_ms = device_ms(torch, lambda: launch(*ptrs), reps=200)
        log(f"propagation: one round {round_ms:.6f} ms; whole fixed point "
            f"{entry['ms']:.6f} ms over {rounds} rounds = "
            f"{entry['ms'] / rounds:.6f} ms per round with the host's "
            f"flag read and synchronise")
    entry["library_ms"] = None
    return entry


def phase_multihop(torch, device, fractions, seed: int) -> None:
    """The paper-scale fleet with fail-close relay chains between
    critical services: breakage climbs several hops, one hop per Jacobi
    round, so an in-place (Gauss-Seidel) kernel would stop in fewer
    rounds than the plain version.  ``broken`` and ``rounds`` exact."""
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.graph import CallGraph
    from repro_torch.graph.propagation import (edge_consts,
                                               shared_blackhole_draws)
    from repro_torch.kernels.ufa import propagation as prop
    fs = synthesize_fleet(scale=1.0, seed=7, as_arrays=True,
                          unsafe_chain_fraction=RELAY_CHAIN_FRACTION)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    consts = edge_consts(graph, device)
    dark, _ = shared_blackhole_draws(graph, fractions, seed=seed)
    dark_d, rounds, _ = hold_propagation(torch, device, consts, dark,
                                         "propagation, relay chains")
    check(rounds > 2, f"propagation, relay chains: {rounds} rounds; the "
          "case needs multi-hop chains (more than 2 rounds)")
    if device.type == "cuda":
        args = (dark_d, consts["ell_dst"], consts["ell_closed"])
        ms = device_ms(torch, lambda: prop.fixed_point_ell(*args), reps=10)
        log(f"propagation, relay chains: whole fixed point {ms:.6f} ms over "
            f"{rounds} rounds = {ms / rounds:.6f} ms per round with the "
            f"host's flag read and synchronise")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def main_grid(n: int) -> dict:
    from repro_torch.core.scenarios import scenario_grid
    from repro_torch.core.sweep_engine import tile_grid
    base = scenario_grid(evict_fraction=(0.25, 0.5, 0.75, 1.0))
    base["storm_refrac"] = np.resize(np.array([0.0, 0.1, 0.3]),
                                     len(base["traffic_mult"]))
    return tile_grid(base, n)


def check_outputs(res: dict, n: int, grid: dict):
    for k, v in res.items():
        check(len(v) == n, f"main: {k} has {len(v)} rows, want {n}")
        if k in grid:
            continue
        check(v.dtype in (np.float32, np.bool_, np.int32),
              f"main: {k} is {v.dtype}")
        # restore times are inf where the scenario never restores
        if v.dtype == np.float32 and k not in ("rl_done_s", "t_rl_done_s",
                                               "t_time_to_restore_s"):
            check(np.isfinite(v).all(), f"main: {k} has non-finite values")
    check(res["t_time_to_restore_s"].shape == (n, 7), "main: tier axis")
    check(res["dep_n_broken_critical"].max() > 0, "main: nothing broke")
    check((res["storm_broken_frac"] > 0).any(), "main: no storm stage")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.scenarios import FleetAggregates
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.core.sweep_engine import SweepEngine
    from repro_torch.core.timeline_sim import config_for_fleet
    from repro_torch.graph import CallGraph
    from repro_torch.graph.propagation import combined_dark_uniques
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import describe_device, resolve_device
    from repro_torch.kernels.ufa.propagation import fixed_point_ell
    from repro_torch.kernels.ufa.reduce import timeline_reduce

    device = resolve_device("cuda")
    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{len(build.SOURCES)} kernels ({len(reports)} compiled now)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # phase 1
    k_reduce = phase_reduce(torch, device)
    log(f"phase 1 ok: timeline_reduce kernel == plain "
        f"(max abs err {k_reduce['max_abs_err']:.3g}) "
        f"{k_reduce['ms']:.6f} ms, plain {k_reduce['plain_ms']:.6f} ms, "
        f"bound {k_reduce['bound_ms']:.6f} ms [{card}]")

    # the paper-scale fleet, graph and main-path grid
    t0 = time.perf_counter()
    fs = synthesize_fleet(scale=1.0, seed=7, as_arrays=True)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    agg = FleetAggregates.from_fleet_state(fs)
    cfg = config_for_fleet(fs)
    grid = main_grid(SCENARIOS)
    log(f"fleet: {fs.n} services, {graph.n_edges} edges, "
        f"{int(graph.critical.sum())} critical, max out-degree "
        f"{int(np.diff(graph.indptr).max())}; set-up "
        f"{time.perf_counter() - t0:.2f} s")

    # phase 2: the main path's dark sets plus the all-preemptible one
    seed = 0
    eng = SweepEngine(agg, cfg, graph=graph, seed=seed, device=device)
    dark_u, _, _ = combined_dark_uniques(
        graph, grid["evict_fraction"], grid["storm_refrac"], seed=seed,
        storm_seed=eng.storm_seed)
    dark = np.concatenate([dark_u, graph.preemptible[None, :]])
    k_prop = phase_propagation(torch, device, graph, dark)
    phase_multihop(torch, device, np.arange(1, 9) / 8.0, seed=3)
    log(f"phase 2 ok: fixed_point_ell kernel == plain (one-hop and relay "
        f"chains), "
        f"{k_prop['ms']:.6f} ms, plain {k_prop['plain_ms']:.6f} ms, "
        f"bound {k_prop['bound_ms']:.6f} ms [{card}]")

    # phase 3: the main path, counts zeroed just before, read just after
    n = SCENARIOS
    timeline_reduce.launches = 0
    fixed_point_ell.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(grid)
    cold = time.perf_counter() - t0
    k_reduce["launches"] = timeline_reduce.launches
    k_prop["launches"] = fixed_point_ell.launches
    check(k_reduce["launches"] > 0, "main path launched no timeline_reduce")
    check(k_prop["launches"] > 0, "main path launched no fixed_point_ell")
    log(f"main path launches: timeline_reduce {k_reduce['launches']}, "
        f"fixed_point_ell {k_prop['launches']} (one per round)")
    check_outputs(res, n, grid)
    warm = []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = eng.run(grid)
        warm.append(time.perf_counter() - t0)
    for k in res:
        check(np.array_equal(res[k], again[k], equal_nan=True),
              f"main: {k} differs between runs")
    log(f"main path {n} scenarios: cold {cold:.4f} s "
        f"({n / cold:.1f} scen/s), warm "
        + ", ".join(f"{w:.4f} s ({n / w:.1f} scen/s)" for w in warm)
        + f" [{card}]")

    # the first chunk against the port's own CPU run, at the two grades
    head = {k: v[:4096] for k, v in grid.items()}
    t0 = time.perf_counter()
    cpu = SweepEngine(agg, cfg, graph=graph, seed=seed,
                      device="cpu").run(head)
    log(f"cpu reference run of {len(head['traffic_mult'])} scenarios: "
        f"{time.perf_counter() - t0:.2f} s")
    gpu_head = {k: v[:4096] for k, v in res.items()}
    rtol = {k: F32_TIGHT for k, v in cpu.items() if v.dtype.kind == "f"}
    rtol["t_availability_mean"] = AVAIL_MEAN_RTOL
    for k in grid:
        rtol.pop(k, None)
    compare(gpu_head, cpu, rtol, "main vs cpu")
    exact = sorted(k for k in cpu if np.array_equal(gpu_head[k], cpu[k],
                                                    equal_nan=True))
    log(f"phase 3 ok: gpu == cpu on the first 4096 scenarios "
        f"({len(exact)} of {len(cpu)} keys bit-identical; differing: "
        f"{sorted(set(cpu) - set(exact))})")

    # where the time goes: one profiled warm run
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(grid)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels_us = {e.key: e.self_device_time_total for e in events
                  if str(e.device_type).endswith("CUDA")}
    busy_us = sum(kernels_us.values())
    table = events.table(sort_by="self_device_time_total", row_limit=25,
                         max_name_column_width=60)
    for line in table.splitlines():
        log("profile |", line)
    if busy_us > 0:
        log(f"profile: device busy {busy_us:.1f} us of {wall_us:.1f} us "
            f"wall (idle share {1 - busy_us / wall_us:.4f}) [{card}]")
        for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]:
            log(f"profile: {us:12.1f} us  {name[:90]}")
    else:
        log("profile: no device time in the trace; not measured")

    kernels = [k_reduce, k_prop]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    dev = describe_device(device)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev["kind"],
                                           "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
