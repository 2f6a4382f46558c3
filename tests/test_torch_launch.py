"""The port's mesh constructors, collective formulas, roofline formulas
and dry run (``repro_torch.launch``) on the CPU.

``model_flops``, ``decode_ideal_bytes`` and the collective formulas are
held exactly to the reference's (``repro.launch.roofline``,
``repro.launch.hlo_analysis`` on tests/test_hlo_and_roofline.py's HLO
string); the dry run builds the per-rank program of the ten REDUCED
configs × four shapes on the ``meta`` device over an abstract (2, 2)
mesh, every cell ``ok`` or the documented ``long_500k`` skip; its FLOPs
equal exactly those of a real CPU run of the same program; a ``meta``
tensor outside a recorder still has no kernel.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import hlo_analysis as ref_hlo  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import SHAPES, all_archs, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, roofline  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import init_abstract, init_params  # noqa: E402
from repro_torch.obs.cost import CostRecorder  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import (TrainState, make_prefill_step,  # noqa: E402
                               make_train_step)
from test_hlo_and_roofline import HLO  # noqa: E402

ARCHS = sorted(all_archs())

# the collectives of tests/test_hlo_and_roofline.py's HLO string as
# dist.smap logs them: (kind, result bytes, group size)
HLO_RECORDS = [
    ("all-gather", 256 * 128 * 4, 2),        # replica_groups=[4,2]
    ("all-reduce", 64 * 4, 4),               # [2,4]
    ("all-reduce", 4, 2),                    # f32[], [4,2]
    ("reduce-scatter", 16 * 8 * 2, 4),       # bf16, [2,4]
    ("collective-permute", 2 * 4 * 4, 1),    # (f32[4], f32[4]); -done once
    ("all-to-all", 2 * (2 * 4 * 4), 2),      # tuple, groups of 2
]


def test_production_mesh_names_and_sizes():
    m1 = port_mesh.make_production_mesh()
    assert m1.axis_names == ("data", "model") and m1.size == 256
    assert m1.shape == {"data": 16, "model": 16} and not m1.live
    m2 = port_mesh.make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    # row-major ranks: the model axis is the fastest
    assert m1.group_ranks("model", 0) == tuple(range(16))
    assert m1.group_ranks("data", 0) == tuple(range(0, 256, 16))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        port_mesh.make_local_mesh(1, 1, device="cpu")


def test_h100_constants_and_link_pricing():
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BANDWIDTH == 3.35e12
    assert port_mesh.SMEM_BYTES_PER_SM == 228 * 1024
    assert port_mesh.link_bandwidth(range(8)) == port_mesh.NVLINK_BANDWIDTH
    assert port_mesh.link_bandwidth(range(16)) == \
        port_mesh.NODE_LINK_BANDWIDTH
    assert port_mesh.link_bandwidth([8, 15]) == port_mesh.NVLINK_BANDWIDTH
    src = open(port_mesh.__file__).read()
    assert "197e12" not in src and "819e9" not in src and "VMEM" not in src


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_decode_bytes_equal_the_reference(arch):
    assert set(SHAPES) == set(REF_SHAPES)
    for shape in SHAPES:
        assert roofline.model_flops(get_arch(arch), shape) == \
            ref_roofline.model_flops(ref_get_arch(arch), shape)
        assert roofline.decode_ideal_bytes(get_arch(arch), shape) == \
            ref_roofline.decode_ideal_bytes(ref_get_arch(arch), shape)


def test_collective_formulas_equal_the_reference_parser():
    assert hlo_analysis.parse_collectives(HLO_RECORDS) == \
        ref_hlo.parse_collectives(HLO)
    assert hlo_analysis.collective_summary(HLO_RECORDS) == \
        ref_hlo.collective_summary(HLO)
    assert hlo_analysis.parse_collectives([]) == \
        ref_hlo.parse_collectives("%dot = f32[8] dot(%a, %b)\n")
    by = hlo_analysis.wire_by_link([r + (True,) for r in HLO_RECORDS[:2]]
                                   + HLO_RECORDS[2:])
    assert by["nvlink"] == pytest.approx(256 * 128 * 4 / 2 + 2 * 3 / 4 * 256)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_reduced_on_an_abstract_mesh(arch, shape):
    spec = get_arch(arch)
    r = dryrun.run_cell(arch, shape, "2x2", cfg=spec.reduced, write=False)
    if not spec.shape_runnable(shape):
        assert r["status"] == "skipped" and shape == "long_500k"
        return
    assert r["status"] == "ok", r.get("traceback")
    assert r["devices"] == 4 and r["flops_per_device"] > 0
    assert r["bytes_per_device"] > 0 and r["peak_bytes"] >= r["base_bytes"]
    # every cell gathers weights over the mesh; a train step also
    # reduce-scatters their gradients
    coll = r["collectives"]
    assert coll["all-gather"]["count"] > 0
    if SHAPES[shape].kind == "train":
        assert coll["reduce-scatter"]["count"] > 0
    json.dumps(r)


def _step_flops(cfg, dev):
    """FLOPs of a prefill and of a train step at B 2 x S 64 on ``dev``."""
    p = init_params(cfg, 0, device="cpu") if dev == "cpu" \
        else init_abstract(cfg)
    if cfg.embed_inputs:
        x = torch.zeros((2, 64), dtype=torch.int64, device=dev)
    else:
        x = torch.zeros((2, 64, cfg.d_model), dtype=cfg.adtype, device=dev)
    y = torch.zeros((2, 64), dtype=torch.int64, device=dev)
    opt = make_optimizer()
    step, _ = make_train_step(cfg, opt, n_loss_chunks=2)
    st = TrainState(p, opt.init(p),
                    torch.zeros((), dtype=torch.int32, device=dev))
    with CostRecorder() as prefill:
        make_prefill_step(cfg)(p, x)
    with CostRecorder() as train:
        step(st, {"inputs": x, "labels": y})
    return prefill, train


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_flops_equal_a_real_cpu_run(arch):
    cfg = get_arch(arch).reduced
    cpu = _step_flops(cfg, "cpu")
    meta = _step_flops(cfg, "meta")
    for a, b in zip(cpu, meta):
        assert a.flops == b.flops and a.flops > 0
        assert a.kernels == b.kernels
    # the train step counts its forward, its backward and the kernels'
    assert cpu[1].flops > 2 * cpu[0].flops
    assert "rmsnorm" in cpu[0].kernels


@pytest.mark.parametrize("causal", [True, False])
def test_attention_pairs_count_the_plain_versions_mask(causal):
    """B6's counted (query, key) pairs == the allowed entries of its plain
    version's mask, for ragged lengths and windows."""
    from repro_torch.kernels.flash_attention import attention_pairs
    for S in (0, 1, 7, 64, 520):
        pos = np.arange(S)
        q, k = pos[:, None], pos[None, :]
        for window in (0, 1, 5, 64, 600):
            valid = (k <= q) if causal else np.ones((S, S), bool)
            if window > 0:
                valid = valid & ((q - k) < window)
            assert attention_pairs(S, causal, window) == int(valid.sum())


def test_meta_outside_a_recorder_has_no_kernel():
    x = torch.empty(4, 8, device="meta")
    s = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.rmsnorm(x, s)
    with CostRecorder() as rec:
        y = ops.rmsnorm(x, s)
    assert y.device.type == "meta" and y.shape == x.shape
    assert rec.kernels["rmsnorm"] == {"calls": 1, "flops": 4 * 4 * 8,
                                      "bytes": 2 * 4 * 8 * 4 + 8 * 4}
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.rmsnorm(x, s)


def test_roofline_reads_the_dryrun_files(tmp_path):
    d = tmp_path / "dryrun"
    for shape in ("train_4k", "decode_32k"):
        r = dryrun.run_cell("llama3.2-3b", shape, "2x2",
                            cfg=get_arch("llama3.2-3b").reduced,
                            art_dir=d)
        assert r["status"] == "ok"
    rows = roofline.analyze("2x2", art=tmp_path)
    assert [r["shape"] for r in rows] == ["train_4k", "decode_32k"]
    for r in rows:
        assert r["status"] == "ok" and r["chips"] == 4
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["t_compute_s"] == pytest.approx(
            r["flops_per_device"] / 989e12)
        assert r["t_memory_s"] == pytest.approx(
            r["bytes_per_device"] / 3.35e12)
        assert 0 < r["roofline_fraction"] and "MXU" not in r["suggestion"]
    md = roofline.to_markdown(rows)
    assert md.count("\n") == 4 and "llama3.2-3b" in md
    assert np.isfinite([r["useful_ratio"] for r in rows]).all()
