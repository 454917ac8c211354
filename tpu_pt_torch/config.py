"""Render configuration (counterpart of ``tpu_pt/config.py``).

The reference's compile-time constants (``PathTracerMain.cpp:41-59``) and
keyboard toggles (``PathTracerMain.cpp:100-141``) as frozen dataclasses.
Field names and defaults are the JAX package's, so one config describes
the same render in both packages.
"""

from __future__ import annotations

import dataclasses

MAX_RECURSION_DEPTH = 28   # pipeline bound, PathTracerMain.cpp:42
DEFAULT_SPP = 128          # samples per launch, PathTracerMain.cpp:43
DEFAULT_MAX_DEPTH = 4      # PathTracerMain.cpp:657
DEFAULT_WIDTH = 512        # PathTracerMain.cpp:58-59
DEFAULT_HEIGHT = 512


@dataclasses.dataclass(frozen=True)
class Quirks:
    """Replicate-the-reference-bug switches. Defaults fix the bugs."""
    # pathTracerPrograms.cu:880 — GGX roughness hardcoded to 0.2.
    fixed_metal_roughness: bool = False
    # pathTracerPrograms.cu:672-681 — only the closest surface occludes.
    occlusion_first_hit_only: bool = False
    # pathTracerPrograms.cu:898-901 — emission only at depth 0 (deeper
    # emissive hits contribute through the radiance channel); turning it
    # off would double-count them.
    emission_depth0_only: bool = True

    @classmethod
    def reference(cls) -> "Quirks":
        return cls(fixed_metal_roughness=True, occlusion_first_hit_only=True)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    spp: int = DEFAULT_SPP
    max_depth: int = DEFAULT_MAX_DEPTH              # 1..28, Up/Down keys
    use_direct_lighting: bool = False               # key '0'
    use_importance_sampling: bool = False           # key '1'
    background: tuple = (0.0, 0.0, 0.0)             # miss color, main.cpp:568
    t_min: float = 0.01                             # pathTracerPrograms.cu:754
    t_max: float = 1e16
    quirks: Quirks = dataclasses.field(default_factory=Quirks)

    # Engine knobs (no reference analog).
    intersector: str = "auto"   # auto | bruteforce | dense
    scheduler: str = "pixelq"   # pixelq (pixel-queue wavefront) | scan
    lanes: int = 262144         # wavefront width cap (pixelq)
    bounces_per_round: int = 1  # regen scheduler only (not ported yet)
    samples_per_item: int = 12  # pixelq: consecutive samples per work item
    fused_nee: bool = False     # fused closest + NEE kernel (not ported yet)
    ray_chunk: int = 8192       # bruteforce: rays per chunk
    tri_block: int = 512        # bruteforce: triangles per block
    spp_chunk: int = 1          # samples traced per scan step

    def __post_init__(self):
        assert 1 <= self.max_depth <= MAX_RECURSION_DEPTH, self.max_depth
        assert self.spp % self.spp_chunk == 0, (self.spp, self.spp_chunk)

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
