"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8
[arXiv:2501.kimi2; unverified]
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab_size=163840,
    n_experts=384, moe_top_k=8, capacity_factor=1.25,
    rope_theta=50000.0, max_seq_len=131072,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="kimi-k2-1t-a32b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab_size=256, n_experts=8, moe_top_k=2,
)

SPEC = register(ArchSpec(
    arch_id="kimi-k2-1t-a32b", family="moe", config=CONFIG, reduced=REDUCED,
    tier=Tier.T1, source="arXiv:2501.kimi2; unverified",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
