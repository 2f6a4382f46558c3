"""The controls of each cell: the reference with one part in a lower
precision (``reference/precision.py``) put in the program's place must
come out not correct, while the program comes out correct, on the same
prompts and weights.  On the CPU at a reduced size (the controls a CPU
can compute apart from float32: TF32 exists only on the card); on the
card at each cell's own size and load (``perfbench_chip``)."""

import pytest
import torch

import control
from bench_tiny import point_at_tiny
from pbharness import files


def fails(numbers, limits):
    return any(not numbers[k] <= lim for k, lim in limits.items())


# the controls a CPU computes apart from float32 (TF32 exists only on the
# card), and the number each is read by against the program's
REDUCED = {"phi3.5-moe": {"fp8": "layer_err_median"},
           "mamba2-780m": {"fp8": "logit_err_mean",
                           "scan_bf16": "scan_err_max"}}


@pytest.mark.parametrize("name", ["phi3.5-moe", "mamba2-780m"])
def test_control_fails_where_the_program_passes_reduced(monkeypatch, name):
    """At a reduced size the program passes the cell's limits, every
    control reads its number at three times the program's or more, and
    the controls together fail the limits on every seed.  Whether each
    control alone fails is decided at the cell's own size on the card:
    at this width the fp8 logits sit at the limit (0.069-0.084 against
    0.07)."""
    torch.set_num_threads(2)
    cell = point_at_tiny(monkeypatch, name)
    limits = files.workload(cell)["check"]["limits"]
    rows = control.readings(cell, [11, 12], {11, 12}, device="cpu",
                            controls=sorted(REDUCED[name]))
    for row in rows:
        assert not fails(row["program"], limits), row
        assert any(fails(n, limits) for n in row["control"].values()), row
        for ctl, main in REDUCED[name].items():
            assert row["control"][ctl][main] >= 3 * row["program"][main], row


@pytest.mark.perfbench_chip
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  files.manifest()["workloads"]])
def test_control_fails_at_the_cells_own_size(chip, cell):
    limits = files.workload(cell)["check"]["limits"]
    rows = control.readings(cell, [101, 102, 103], {101, 102, 103},
                            device=chip)
    for row in rows:
        assert not fails(row["program"], limits), row
        for name, numbers in row["control"].items():
            assert fails(numbers, limits), (name, row)
