"""The operation and byte counts against shapes worked out by hand, and
the roofline and mfu readers on a made-up trace."""

import pytest
import torch

from pbharness import files, peaks, readers

b6 = files.load_module("counts", "b6")
b7 = files.load_module("counts", "b7")
b8 = files.load_module("counts", "b8")
model_flops = files.load_module("counts", "model_flops")


def t(shape, dtype=torch.bfloat16):
    return {"shape": list(shape), "dtype": dtype,
            "itemsize": torch.empty((), dtype=dtype).element_size()}


def test_b6_causal_and_windowed():
    q = t((1, 4, 2, 8))
    # causal over 4 positions: 1 + 2 + 3 + 4 = 10 pairs a head, 4 d each
    assert b6.count({"args": [q, q, q], "kwargs": {}}) == \
        (4 * 8 * 10 * 2, 4 * 4 * 2 * 8 * 2, torch.bfloat16)
    # window 2: 1 + 2 + 2 + 2 = 7 pairs; no mask: 16
    assert b6.count({"args": [q, q, q], "kwargs": {"window": 2}})[0] == 4 * 8 * 7 * 2
    assert b6.count({"args": [q, q, q], "kwargs": {"causal": False}})[0] == 4 * 8 * 16 * 2


def test_b6_at_the_cells_shape():
    q = t((2, 4096, 32, 128))
    flops, nbytes, _ = b6.count({"args": [q, q, q], "kwargs": {"causal": True}})
    assert flops == 4 * 128 * (4096 * 4097 // 2) * 2 * 32 == 274_945_015_808
    assert nbytes == 4 * 2 * 4096 * 32 * 128 * 2


def test_b7():
    x, w = t((2, 3, 4)), t((2, 4, 5))
    assert b7.count({"args": [x, w], "kwargs": {}}) == \
        (2 * 2 * 3 * 4 * 5, (24 + 40 + 30) * 2, torch.bfloat16)
    # phi3.5-moe's up product at 8,192 tokens: 16 experts x 1,280 slots
    flops, nbytes, _ = b7.count({"args": [t((16, 1280, 4096)),
                                          t((16, 4096, 6400))], "kwargs": {}})
    assert flops == 2 * 16 * 1280 * 4096 * 6400
    assert nbytes == 2 * (16 * 1280 * 4096 + 16 * 4096 * 6400 + 16 * 1280 * 6400)


def test_b8():
    f = torch.float32
    args = [t((1, 8, 2, 2), f), t((1, 8, 2), f), t((2,), f), t((1, 8, 1, 3), f),
            t((1, 8, 1, 3), f), 4]
    flops, nbytes, dtype = b8.count({"args": args, "kwargs": {}})
    # 2 chunks; a chunk: C.B over 10 pairs (60), y over 10 pairs x 2 heads
    # (80), states and read-out 4 positions x 2 heads x 2 x 2 x 3 x 2
    # (192), the carry 2 heads x 2 x 2 x 3 (24)
    assert flops == 2 * (60 + 80 + 192 + 24)
    # x and y 128 + 128, dt 64, a 8, b and c 96 + 96, the state 48
    assert nbytes == 568 and dtype == torch.float32


def test_model_flops_phi_by_hand():
    lc = files.config("phi3.5-moe")["lm_config"]
    per_token = (4096 * (32 + 16) * 128 + 32 * 128 * 4096   # projections
                 + 4096 * 16                               # router
                 + 2 * 3 * 4096 * 6400)                    # two experts
    assert per_token == 199_294_976
    attention = 4 * 128 * 32 * 2 * (4096 * 4097 // 2)
    want = 16 * (2 * per_token * 8192 + attention) + 2 * 4096 * 32064 * 2
    assert model_flops.prefill_flops(lc, 2, 4096) == want == 56_643_627_778_048


def test_model_flops_mamba_by_hand():
    lc = files.config("mamba2-780m")["lm_config"]
    per_token = 1536 * (2 * 3072 + 2 * 128 + 48) + 4 * (3072 + 256) + 3072 * 1536
    tri = 256 * 257 // 2
    ssd = 2 * 16 * (tri * 2 * 128 + 48 * tri * 2 * 64 + 48 * 256 * 4 * 64 * 128
                     + 48 * 2 * 64 * 128)
    want = 48 * (2 * per_token * 8192 + ssd) + 2 * 1536 * 50288 * 2
    assert model_flops.prefill_flops(lc, 2, 4096) == want


class FakeTrace:
    def __init__(self, device_s, calls, steps=2, window_s=1.0, busy_s=0.9,
                 kind="NVIDIA H100 80GB HBM3"):
        self.device_s, self.calls = device_s, calls
        self.steps, self.window_s, self.busy_s = steps, window_s, busy_s
        self.context = {"peaks": peaks.for_kind(kind),
                        "count": lambda n: files.load_module("counts", n),
                        "lm_config": files.config("phi3.5-moe")["lm_config"],
                        "shapes": [(2, 4096)] * steps}

    def span_device_s(self, path):
        return self.device_s.get(path, 0.0)


def test_roofline_and_span_readers():
    path = "repro_torch.kernels.ops.grouped_matmul"
    call = {"args": [t((16, 1280, 4096)), t((16, 4096, 6400))], "kwargs": {}}
    least = max(2 * 16 * 1280 * 4096 * 6400 / 989e12,
                2 * (16 * 1280 * 4096 + 16 * 4096 * 6400 + 16 * 1280 * 6400)
                / 3.35e12)
    tr = FakeTrace({path: 2 * least}, {path: [call]})
    assert readers.roofline_pct(tr, path, "b7") == pytest.approx(50.0)
    assert readers.span_ms(tr, path) == pytest.approx(1e3 * least)
    # nothing read: no value, never 0
    assert readers.roofline_pct(FakeTrace({}, {}), path, "b7") is None
    assert readers.roofline_pct(FakeTrace({path: 1.0}, {path: [call]},
                                          kind="other"), path, "b7") is None


def test_mfu_and_idle_readers():
    mfu = files.load_module("metrics", "mfu.prefill")
    idle = files.load_module("metrics", "idle_share.prefill")
    tr = FakeTrace({}, {}, steps=3, window_s=0.75, busy_s=0.6)
    assert mfu.read(tr) == pytest.approx(
        100 * 3 * 56_643_627_778_048 / (0.75 * 989e12))
    assert idle.read(tr) == pytest.approx(20.0)
    assert idle.read(FakeTrace({}, {}, busy_s=0.0)) is None


def test_least_seconds_picks_the_longer_bound():
    pk = peaks.for_kind("NVIDIA H100 80GB HBM3")
    assert peaks.least_seconds(pk, 989e12, 1.0, torch.bfloat16) == pytest.approx(1.0)
    assert peaks.least_seconds(pk, 1.0, 3.35e12, torch.float32) == pytest.approx(1.0)
    assert peaks.least_seconds(pk, 494.5e12, 1.0, torch.float32) == pytest.approx(1.0)
