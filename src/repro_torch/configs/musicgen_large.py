"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048  [arXiv:2306.05284; hf]
Modality frontend (EnCodec) is a stub: input_specs() provides precomputed
frame embeddings (B, S, d_model).
"""

from repro_torch.configs.base import ArchSpec, register, FULL_ATTENTION_500K_SKIP
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=2048,
    embed_inputs=False,          # EnCodec frame embeddings from the stub frontend
    rope_theta=1e4, max_seq_len=32768,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="musicgen-large-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=128, embed_inputs=False,
)

SPEC = register(ArchSpec(
    arch_id="musicgen-large", family="audio", config=CONFIG, reduced=REDUCED,
    tier=Tier.T3, source="arXiv:2306.05284; hf",
    skips={"long_500k": FULL_ATTENTION_500K_SKIP},
))
