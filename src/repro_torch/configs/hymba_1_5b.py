"""hymba-1.5b [hybrid] — parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf]

Global full attention at layers {0, 15, 31}; sliding window (1024) elsewhere
(per the Hymba paper).  Meta-tokens are omitted: the assignment's backbone
spec is authoritative.  sub_quadratic: mamba heads are O(1)-state and 29/32
attention layers have window-bounded KV, so long_500k runs.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

_WINDOWS = tuple(0 if i in (0, 15, 31) else 1024 for i in range(32))

CONFIG = LMConfig(
    name="hymba-1.5b",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001, block="hybrid",
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    window_pattern=_WINDOWS, rope_theta=1e4,
    tie_embeddings=True, max_seq_len=1 << 20, sub_quadratic=True,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="hymba-1.5b-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, block="hybrid",
    ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
    window_pattern=(0, 8, 8, 0), tie_embeddings=True, sub_quadratic=True,
)

SPEC = register(ArchSpec(
    arch_id="hymba-1.5b", family="hybrid", config=CONFIG, reduced=REDUCED,
    tier=Tier.T4, source="arXiv:2411.13676; hf",
    skips={},
))
