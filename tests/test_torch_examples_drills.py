"""The port's drill and optimizer drivers against the reference's
(``examples/live_failover_drill.py --smoke``,
``optimize_capacity.py --smoke``, ``failover_drill.py``), both run in
this process on the CPU, every printed line equal under
``repro_torch.examples.compare``'s rules; lines that follow the random
weights or the optimizer's draws are held to the reference driver's own
asserts, which the port's driver keeps.  And the port fault the
optimizer driver exposed: ``hardening_weights`` refused the host knobs
``optimize_capacity`` returns."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_examples import (  # noqa: E402,F401
    assert_same, one_torch_thread, planes_off, run_port, run_reference)

CASES = [("live_failover_drill", ("--smoke",)),
         ("optimize_capacity", ("--smoke",)), ("failover_drill", ())]


@pytest.mark.parametrize("name,argv", CASES, ids=[c[0] for c in CASES])
def test_driver_prints_the_reference_lines(name, argv):
    want = run_reference(name, argv)
    got = run_port(name, argv)
    assert_same(name, got, want)
    if name == "live_failover_drill":
        # the driver's SLA asserts passed (live_failover_drill.py:49-56)
        assert got.splitlines()[-1].startswith("PASS  critical T1")
    if name == "optimize_capacity":
        # improved and hard-verified (:58-60), <= 1.4x (:61-64), and the
        # weighted plan certifies (:72)
        assert "-> all_ok=True" in got
        assert got.rstrip().endswith("certified=True")


def test_hardening_weights_take_the_optimizers_host_knobs():
    """``optimize_capacity(...).knobs`` are host arrays, and the
    reference's ``hardening_weights`` takes them; the port's raised
    ``TypeError`` (``torch.sigmoid`` of a numpy array).  Host knobs now
    give the same weights as the same knobs on the device, and the
    reference's weights on the same knobs."""
    from repro.core.service import synthesize_fleet as ref_synth
    from repro.graph import CallGraph as RefGraph
    from repro.optim import hardening_weights as ref_weights
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.graph import CallGraph
    from repro_torch.optim import hardening_weights
    from repro_torch.optim.capacity import ufa_knobs

    fs = synthesize_fleet(scale=0.02, seed=7, as_arrays=True)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    knobs = {k: v + 0.25 for k, v in ufa_knobs("cpu").items()}
    host = {k: v.numpy() for k, v in knobs.items()}
    got = hardening_weights(fs, graph, knobs=host, device="cpu")
    same = hardening_weights(fs, graph, knobs=knobs, device="cpu")
    np.testing.assert_array_equal(got, same)
    rfs = ref_synth(scale=0.02, seed=7, as_arrays=True)
    rfs.apply_ufa_target_classes()
    want = np.asarray(ref_weights(rfs, RefGraph.from_fleet_state(rfs),
                                  knobs=host))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
