"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]

long_500k RUNS for this arch: 5/6 of layers have window-bounded (1024) KV;
the 1-in-6 global layers hold full-length KV, which at decode is
linear-compute and sequence-shardable.  See DESIGN.md §Arch-applicability.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab_size=262144,
    qk_norm=True,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),   # 5 local : 1 global
    rope_theta=1e6, rope_theta_local=1e4,
    tie_embeddings=True, embed_scale=True, max_seq_len=131072,
    sub_quadratic=True,
    param_dtype="bfloat16", activ_dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="gemma3-4b-reduced",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, qk_norm=True,
    window_pattern=(8, 8, 8, 8, 8, 0), rope_theta=1e6, rope_theta_local=1e4,
    tie_embeddings=True, embed_scale=True, sub_quadratic=True,
)

SPEC = register(ArchSpec(
    arch_id="gemma3-4b", family="dense", config=CONFIG, reduced=REDUCED,
    tier=Tier.T2, source="hf:google/gemma-3-1b-pt; unverified",
    skips={},
))
