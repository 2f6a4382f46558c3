"""internvl2-76b [vlm] — InternViT + InternLM2 backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256  [arXiv:2404.16821; unverified]
Vision frontend (InternViT) is a stub: input_specs() provides precomputed
patch embeddings (B, S, d_model).
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="internvl2-76b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab_size=128256,
    embed_inputs=False,          # patch/text embeddings from the stub frontend
    rope_theta=1e6, max_seq_len=32768,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="internvl2-76b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=160, vocab_size=256, embed_inputs=False,
)

SPEC = register(ArchSpec(
    arch_id="internvl2-76b", family="vlm", config=CONFIG, reduced=REDUCED,
    tier=Tier.T2, source="arXiv:2404.16821; unverified",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
