"""The port's request campaign on the CPU: the reference test
``test_request_campaign_localizes_arrival_frontier_and_replays``
(``tests/test_serving_failover.py``) mirrored on ``repro_torch.serving``,
and the port's frontier equal to the reference's.  A file of its own:
its drills take most of a minute, and ``--dist loadfile`` spreads files
over workers."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import verify_report  # noqa: E402
from repro_torch.chaos.campaign import Ray  # noqa: E402
from repro_torch.serving import (DrillSpec, drill_oracle,  # noqa: E402
                                 request_campaign)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tiny decode steps (the drills
    run thousands; more threads only contend with the other workers),
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_spec():
    return DrillSpec(horizon_s=7200.0, n_steps=48, ticks_per_step=4,
                     crit_rps=0.03, pre_rps=0.02, max_new_tokens=2,
                     seed=11)


def test_request_campaign_localizes_arrival_frontier_and_replays():
    spec = _small_spec()
    camp = request_campaign(
        spec, rays=(Ray("arrival_spike", {"arrival_spike": 1.0}),),
        tol=1.0 / 4.0, max_rounds=3, device=CPU)
    rep = camp.run()
    assert rep.op_ok
    ray = rep.ray("arrival_spike")
    assert ray.status == "localized"
    assert 0.0 < ray.frontier_severity < 1.0
    knobs = ray.frontier_knobs()
    assert knobs["arrival_mult"] > 1.0
    assert ray.counterexample["arrival_mult"] > knobs["arrival_mult"]

    # bit-exact replay through a fresh oracle (fresh drills per row)
    out = verify_report(rep, oracle=drill_oracle(spec, device=CPU))
    assert out["n_probes"] == rep.n_evals and not out["mismatches"]
