"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128  [arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="mamba2-780m",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=1, d_head=1,
    d_ff=0, vocab_size=50280, block="ssm",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True, max_seq_len=1 << 20, sub_quadratic=True,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="mamba2-780m-reduced",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=1, d_head=1,
    d_ff=0, vocab_size=256, block="ssm",
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8, tie_embeddings=True,
    sub_quadratic=True,
)

SPEC = register(ArchSpec(
    arch_id="mamba2-780m", family="ssm", config=CONFIG, reduced=REDUCED,
    tier=Tier.T3, source="arXiv:2405.21060; unverified",
    skips={},
))
