"""Architecture registry: the architectures the port runs × input shapes.

Each arch module defines ``CONFIG`` (exact assigned numbers), ``REDUCED``
(same family, tiny, for CPU smoke tests) and registers itself here.  The
port of ``repro/configs/base.py`` without ``input_specs`` (which builds
JAX shape stand-ins); only the architectures the port's models run are
registered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig

# ---------------------------------------------------------------------------
# Shapes (assigned): all LM-family archs share these four shape cells.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # audio|dense|ssm|moe|vlm|hybrid
    config: LMConfig
    reduced: LMConfig
    tier: Tier                     # business-criticality tier for UFA examples
    source: str
    # shape-name -> skip reason (None = runs)
    skips: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)

    def shape_runnable(self, shape: str) -> bool:
        return self.skips.get(shape) is None


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _load_all()
    return _REGISTRY[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    _load_all()
    return dict(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import mamba2_780m  # noqa: F401
    _LOADED = True
