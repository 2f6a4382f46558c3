"""The port's trainer, the paper's preempt-and-restore story and the train
CLI on the CPU, beside the reference's ``repro.train.trainer``.

  - ``Trainer`` resume: 5 steps, a checkpoint, ``maybe_resume`` into a
    fresh state and 5 more give the 10 straight steps' losses bit for
    bit, and the reference Trainer's losses on the same weights within
    rtol 1e-5; the preempt hook stops at a step boundary with a final
    checkpoint; the straggler watchdog and periodic checkpoints.
  - ``tests/test_system.py`` mirrored on the port: a critical serving
    engine beside a preemptible trainer, the orchestrator's eviction hook
    preempting the trainer and entering failover, T1 unharmed and T5
    dark, the trainer resumed from its checkpoint, failback.
  - ``python -m repro_torch.launch.train --device cpu``: the reference's
    two output lines (the first equal to the reference CLI's), the
    report it returns, ``--devices 2`` and ``--mesh`` refused, and the
    stub-frontend configs raising where the reference CLI raises.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import SyntheticLMDataset as RefDataset  # noqa: E402
from repro.data import make_train_iterator as ref_iterator  # noqa: E402
from repro.models import LMConfig as RefLMConfig  # noqa: E402
from repro.train import make_train_state as ref_make_state  # noqa: E402
from repro.train import make_train_step as ref_make_step  # noqa: E402
from repro.train.trainer import Trainer as RefTrainer  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.capacity import RegionCapacity  # noqa: E402
from repro_torch.core.drills import remediate  # noqa: E402
from repro_torch.core.omg import Orchestrator  # noqa: E402
from repro_torch.core.service import synthesize_fleet, unsafe_edges  # noqa: E402
from repro_torch.core.tiers import Tier  # noqa: E402
from repro_torch.data import SyntheticLMDataset, make_train_iterator  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import LMConfig, init_params  # noqa: E402
from repro_torch.serving import (Request, ServingEngine,  # noqa: E402
                                 TieredScheduler)
from repro_torch.train import (TrainState, make_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.train.trainer import Trainer  # noqa: E402

CPU = "cpu"
_CFG = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab_size=128, tie_embeddings=True)
CFG = LMConfig(**_CFG)


def _ds():
    return SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4,
                              seed=2)


def _ref_weights_state(opt):
    """The port's TrainState on the reference's ``PRNGKey(0)`` weights."""
    rp = ref_make_state(RefLMConfig(**_CFG), jax.random.PRNGKey(0)).params
    p = params_from_reference(rp, CPU)
    return TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))


def test_trainer_resume_deterministic_and_equal_to_the_reference():
    """Preempt/restore (UFA BBM) is bit-deterministic: 10 straight steps
    and 5 + checkpoint + resume 5 give the same losses, and the same as
    the reference's Trainer on the same weights and batches."""
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    st = _ref_weights_state(opt)
    it = make_train_iterator(_ds(), device=CPU)
    straight = []
    for _ in range(10):
        st, m = step_fn(st, next(it))
        straight.append(float(m["loss"]))
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, step_fn, d, checkpoint_every=100)
        st, rep1 = tr.run(_ref_weights_state(opt),
                          make_train_iterator(_ds(), device=CPU), 5)
        assert latest_step(d) == 5 and rep1.resumed_from is None
        junk = make_train_state(CFG, 9, opt, device=CPU)
        st2, start = tr.maybe_resume(junk, device=CPU)
        assert start == 5 and int(st2.step) == 5
        st2, rep2 = tr.run(st2, make_train_iterator(_ds(), start_step=start,
                                                    device=CPU),
                           5, start_step=start)
        assert rep2.resumed_from == 5 and rep2.steps_done == 5
    assert rep1.losses + rep2.losses == straight

    ref_step, ref_opt = ref_make_step(RefLMConfig(**_CFG), n_loss_chunks=2)
    with tempfile.TemporaryDirectory() as d:
        rst = ref_make_state(RefLMConfig(**_CFG), jax.random.PRNGKey(0),
                             ref_opt)
        _, ref_rep = RefTrainer(RefLMConfig(**_CFG), ref_step, d).run(
            rst, ref_iterator(RefDataset(vocab_size=128, seq_len=16,
                                         global_batch=4, seed=2)), 10)
    np.testing.assert_allclose(straight, ref_rep.losses, rtol=1e-5)


def test_maybe_resume_without_checkpoint_keeps_the_state():
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    st = make_train_state(CFG, 0, opt, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        got, start = Trainer(CFG, step_fn, d).maybe_resume(st, device=CPU)
    assert start == 0 and got is st


def test_trainer_preempt_hook():
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, step_fn, d)
        st = make_train_state(CFG, 0, opt, device=CPU)
        tr.request_preempt()
        st, rep = tr.run(st, make_train_iterator(_ds(), device=CPU), 10)
        assert rep.preempted and rep.steps_done == 0
        assert np.isnan(rep.final_loss)
        assert latest_step(d) == 0              # final checkpoint written


def test_trainer_preempts_mid_run_and_checkpoints_periodically():
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, step_fn, d, checkpoint_every=2)

        def step_then_preempt(state, batch):
            out = step_fn(state, batch)
            if int(out[0].step) == 3:
                tr.request_preempt()
            return out

        tr.train_step = step_then_preempt
        st, rep = tr.run(make_train_state(CFG, 0, opt, device=CPU),
                         make_train_iterator(_ds(), device=CPU), 10)
        assert rep.preempted and rep.steps_done == 3 and int(st.step) == 3
        assert sorted(os.listdir(d)) == ["step_0000000002",
                                         "step_0000000003"]


def test_straggler_watchdog_stops_after_max_strays():
    """A step slower than ``straggler_factor`` x the EWMA (after the third
    step) is recorded; beyond ``max_strays`` the loop stops with a
    checkpoint."""
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    clock = iter([0.0, 1.0] * 4 + [t for i in range(20)
                                   for t in (10.0 * i, 10.0 * i + 9.0)])

    def fake_step(state, batch):
        return state, {"loss": torch.tensor(1.0)}

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, fake_step, d, straggler_factor=3.0, max_strays=2)
        import repro_torch.train.trainer as trainer_mod
        real = trainer_mod.time.perf_counter
        trainer_mod.time.perf_counter = lambda: next(clock)
        try:
            st, rep = tr.run(make_train_state(CFG, 0, opt, device=CPU),
                             iter(lambda: {}, None), 20)
        finally:
            trainer_mod.time.perf_counter = real
        assert len(rep.straggler_steps) == 3 and rep.steps_done == 7
        assert [s for s, _, _ in rep.straggler_steps] == [4, 5, 6]
        assert latest_step(d) == 7


def test_end_to_end_ufa_failover_with_real_workloads():
    """``tests/test_system.py``'s story on the port, on the CPU."""
    # --- control plane: fleet + remediation + orchestrator -------------
    fleet = synthesize_fleet(scale=0.02, seed=4)
    remediate(fleet, set(unsafe_edges(fleet)))
    region = RegionCapacity.for_fleet("r", fleet)

    # --- data plane: a critical serving engine + a preemptible trainer --
    params = init_params(CFG, 0, device=CPU)
    engine = ServingEngine(CFG, params, max_batch=4, max_seq=48)
    sched = TieredScheduler({"e": engine})
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4,
                            seed=1)

    events = {"evicted": 0, "restored": 0}

    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(CFG, step_fn, ckdir, checkpoint_every=2)
        tstate = make_train_state(CFG, 0, opt, device=CPU)
        # batch training runs opportunistically in overcommit capacity
        tstate, rep0 = trainer.run(tstate, make_train_iterator(
            ds, device=CPU), 4)

        def on_evict(spec):
            events["evicted"] += 1
            if events["evicted"] == 1:     # preempt the training job (BBM)
                trainer.request_preempt()
                sched.enter_failover()

        def on_restore(spec):
            events["restored"] += 1

        orch = Orchestrator(fleet, region, scale=0.02,
                            on_evict=on_evict, on_restore=on_restore)
        report = orch.failover(tv_failover=1.0)

        # serve during the failover window: critical only
        rng = np.random.default_rng(0)
        for i in range(12):
            sched.submit(Request(i, tier=Tier(i % 6),
                                 prompt=list(rng.integers(0, 128, 8)),
                                 max_new_tokens=2))
        for _ in range(40):
            sched.tick()

        # --- assertions: the paper's claims -----------------------------
        assert report.mode == "peak"
        assert report.always_on_ok                      # Fig 8: no impact
        assert report.rl_rto_met                        # Table 4: <= 1h
        assert events["evicted"] > 0 and events["restored"] > 0
        assert engine.availability(Tier.T1) == 1.0      # critical unharmed
        assert engine.counters["served"][Tier.T5] == 0  # preempted tier dark

        # restore the preempted training job from checkpoint (BBM revive)
        sched.exit_failover()
        t2 = make_train_state(CFG, 7, opt, device=CPU)
        t2, start = trainer.maybe_resume(t2, device=CPU)
        assert start >= 4
        assert torch.equal(t2.params["embed"], tstate.params["embed"])
        trainer._preempt_requested = False
        t2, rep2 = trainer.run(t2, make_train_iterator(
            ds, start_step=start, device=CPU), 3, start_step=start)
        assert rep2.steps_done == 3                     # training continues

        orch.failback()
        for s in orch.se.values():
            assert s.placement == "steady"


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = train_cli.main(argv)
    return buf.getvalue(), rep


_REF_FIRST = {   # the reference CLI's first line for these archs
    "qwen3-1.7b": "arch=qwen3-1.7b cfg=qwen3-1.7b-reduced params=0.1M "
                  "devices=1",
    "phi3.5-moe-42b-a6.6b": "arch=phi3.5-moe-42b-a6.6b "
                            "cfg=phi3.5-moe-42b-a6.6b-reduced params=0.2M "
                            "devices=1",
    "mamba2-780m": "arch=mamba2-780m cfg=mamba2-780m-reduced params=0.1M "
                   "devices=1",
}


@pytest.mark.parametrize("arch", sorted(_REF_FIRST))
def test_train_cli_output_lines(arch):
    with tempfile.TemporaryDirectory() as d:
        out, rep = _cli(["--arch", arch, "--steps", "3", "--device", "cpu",
                         "--ckpt-dir", d])
        assert latest_step(d) == 3
    lines = out.rstrip("\n").split("\n")
    assert len(lines) == 2 and lines[0] == _REF_FIRST[arch]
    m = re.fullmatch(r"done: 3 steps, loss (\S+) -> (\S+), stragglers=(\d+)",
                     lines[1])
    assert m, lines[1]
    assert rep.steps_done == 3 and len(rep.losses) == 3
    assert m.group(1) == f"{rep.losses[0]:.3f}"
    assert m.group(2) == f"{rep.final_loss:.3f}"
    assert int(m.group(3)) == len(rep.straggler_steps)
    assert all(np.isfinite(rep.losses))


def test_train_cli_defaults():
    ap_defaults = {"--steps": 20, "--batch": 8, "--seq": 64}
    with tempfile.TemporaryDirectory() as d:
        out, rep = _cli(["--steps", "2", "--device", "cpu", "--ckpt-dir", d])
    assert out.startswith("arch=qwen3-1.7b cfg=qwen3-1.7b-reduced ")
    assert rep.steps_done == 2 and ap_defaults["--batch"] == 8
    src = open(train_cli.__file__).read()
    for flag, value in ap_defaults.items():
        assert re.search(rf'"{flag}", type=int, default={value}\)', src)
    assert 'ap.add_argument("--device", default="cuda")' in src
    assert "tempfile.gettempdir()" in src


def _cli_subprocess(argv):
    """The CLI as a process (its ranks print from their own processes):
    its output lines and rank 0's losses."""
    code = ("import json, sys\n"
            "from repro_torch.launch.train import main\n"
            "rep = main(sys.argv[1:])\n"
            "print('LOSSES', json.dumps(rep.losses))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    return lines[:-1], json.loads(lines[-1].split("LOSSES", 1)[1])


@pytest.mark.parametrize("argv", [["--devices", "2"], ["--mesh", "2x1"],
                                  ["--devices", "4", "--mesh", "2x2"]])
def test_train_cli_refuses_a_mesh(argv, tmp_path):
    """These arguments once raised; now each does what the reference's
    CLI does with them: --devices N trains on N ranks over the mesh
    (--mesh DxM, default Nx1), --mesh without --devices > 1 stays on one
    device.  Rank 0's lines are the reference's, and the losses those of
    one device (2 steps; 1e-5)."""
    base = ["--steps", "2", "--device", "cpu"]
    lines, losses = _cli_subprocess(
        [*argv, *base, "--ckpt-dir", str(tmp_path / "mesh")])
    devices = int(argv[1]) if argv[0] == "--devices" else 1
    assert lines[0] == ("arch=qwen3-1.7b cfg=qwen3-1.7b-reduced "
                        f"params=0.1M devices={devices}")
    assert re.fullmatch(r"done: 2 steps, loss \S+ -> \S+, stragglers=\d+",
                        lines[1]), lines
    assert len(lines) == 2 and latest_step(tmp_path / "mesh") == 2
    _, one = _cli(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                   str(tmp_path / "one")])
    np.testing.assert_allclose(losses, one.losses, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["internvl2-76b", "musicgen-large"])
def test_train_cli_stub_frontends_raise_as_the_reference(arch):
    """The reference CLI hands token ids to configs whose frontend stub
    takes (B, S, d_model) embeddings, and its forward raises
    ``ValueError`` unpacking them; the port's does too."""
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="not enough values to unpack"):
            _cli(["--arch", arch, "--steps", "1", "--device", "cpu",
                  "--ckpt-dir", d])


def test_train_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="CUDA"):
            _cli(["--steps", "1", "--ckpt-dir", d])
