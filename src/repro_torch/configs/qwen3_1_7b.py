"""qwen3-1.7b [dense] — qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936  [hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="qwen3-1.7b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True, max_seq_len=40960,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="qwen3-1.7b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, qk_norm=True, tie_embeddings=True,
)

SPEC = register(ArchSpec(
    arch_id="qwen3-1.7b", family="dense", config=CONFIG, reduced=REDUCED,
    tier=Tier.T1, source="hf:Qwen/Qwen3-8B; hf",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
