"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab_size=32064,
    n_experts=16, moe_top_k=2, capacity_factor=1.25,
    rope_theta=1e4, max_seq_len=131072,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="phi3.5-moe-42b-a6.6b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab_size=256, n_experts=4, moe_top_k=2,
)

SPEC = register(ArchSpec(
    arch_id="phi3.5-moe-42b-a6.6b", family="moe", config=CONFIG, reduced=REDUCED,
    tier=Tier.T2, source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
