"""Render configuration.

A real config system replacing the reference's compile-time constants
(``PathTracerMain.cpp:41-59``: 512x512, 128 spp, depth default 4 / max 28,
hardcoded OBJ path) and its keyboard-toggle runtime state ('0' direct
lighting, '1' importance sampling, Up/Down depth; ``PathTracerMain.cpp:
100-141``). Frozen dataclasses so configs are hashable and usable as jit
static arguments — toggling a flag selects a cached executable, mirroring
the reference's accumulation reset on toggle.
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
    """Replicate-the-reference-bug switches (SURVEY.md §7 hard-part 5).

    Defaults fix the bugs; enable for RMSE comparison against the reference.
    """
    # pathTracerPrograms.cu:880 — ``roughness = 0.2; rt_data->roughness;``
    # typo hardcodes GGX roughness to 0.2 regardless of material.
    fixed_metal_roughness: bool = False
    # pathTracerPrograms.cu:672-681 — occlusion tests only the FIRST hit
    # (approximated as: only the closest surface can occlude).
    occlusion_first_hit_only: bool = False
    # pathTracerPrograms.cu:898-901 — emission contributes only at depth 0
    # (deeper hits add emission via the LIGHT_HIT radiance channel instead).
    # This one is load-bearing for energy accounting, so it is ON by default:
    # turning it off would double-count emissive hits given the radiance
    # channel. Kept as a flag to document the structure.
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
    intersector: str = "auto"   # auto | bruteforce | pallas | bvh
    scheduler: str = "pixelq"   # pixelq (pixel-queue wavefront, scatter-free)
                                # | regen (item-queue wavefront) | scan
    lanes: int = 262144         # wavefront width cap (regen scheduler);
                                # larger frames stream items through it
    bounces_per_round: int = 1  # trace steps per work-queue round (regen):
                                # >1 accumulates contributions in registers
                                # and scatters once per round, at the cost
                                # of lanes idling once their path ends.
    samples_per_item: int = 12  # pixelq scheduler: samples per work item
                                # (clamped to spp). Larger = fewer slot
                                # flushes + smaller drain scatter; smaller
                                # = shorter frame tail (the last wave is
                                # bounded by the unluckiest item's
                                # samples_per_item x max_depth rounds).
    ray_chunk: int = 8192
    tri_block: int = 512
    spp_chunk: int = 1          # samples traced per scan step

    def __post_init__(self):
        assert 1 <= self.max_depth <= MAX_RECURSION_DEPTH, self.max_depth
        assert self.spp % self.spp_chunk == 0, (self.spp, self.spp_chunk)

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
