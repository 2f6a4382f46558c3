"""command-r-plus-104b [dense] — GQA, no-bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab_size=256000,
    rope_theta=75e6, max_seq_len=131072,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="command-r-plus-104b-reduced",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=192, vocab_size=256,
)

SPEC = register(ArchSpec(
    arch_id="command-r-plus-104b", family="dense", config=CONFIG, reduced=REDUCED,
    tier=Tier.T1, source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
