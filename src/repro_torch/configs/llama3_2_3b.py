"""llama3.2-3b [dense] — small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="llama3.2-3b",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=128256,
    rope_theta=500000.0, tie_embeddings=True, max_seq_len=131072,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="llama3.2-3b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, tie_embeddings=True,
)

SPEC = register(ArchSpec(
    arch_id="llama3.2-3b", family="dense", config=CONFIG, reduced=REDUCED,
    tier=Tier.T1, source="hf:meta-llama/Llama-3.2-1B; unverified",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
