"""Render configuration.

The reference hardcodes nearly everything (RayZen/src/main.cpp:35-36 resolution,
RayZen/shaders/fragment_shader.glsl:673-675 bounces/spp, RayZen/src/BVH.cpp:115 leaf
size, fragment_shader.glsl:764 Russian-roulette start). SURVEY.md §5 calls for
promoting those constants to a config object; this dataclass is that object, plus the
reference's actual CLI flags (--log, --rebuild-bvh, --warmup-frames,
--path-tracer-only; RayZen/src/main.cpp:141-160).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering parameters. Hashable so it can key jit specializations."""

    # Framebuffer (reference default 800x600: RayZen/src/main.cpp:35-36).
    width: int = 800
    height: int = 600

    # Sampling (reference: numSamples=1, maxBounces=5, frame 0 uses bounce budget 1;
    # fragment_shader.glsl:673-675, main.cpp:600).
    spp: int = 1
    max_bounces: int = 5
    first_frame_bounces: int = 1

    # Russian roulette kicks in for bounce indices > rr_start_bounce
    # (fragment_shader.glsl:764).
    rr_start_bounce: int = 2

    # BVH build (SAH default: BVH.h:34). The reference caps leaves at 4
    # triangles (BVH.cpp:115); fatter leaves trade triangle tests for fewer
    # traversal steps and produce identical images — tree shape never changes
    # closest hits. Set 4 for build-structure parity.
    leaf_size: int = 8
    split_method: str = "sah"  # "sah" | "midpoint"

    # RNG: "reference" reproduces the sin-hash sampling flow of
    # fragment_shader.glsl:188-190 for image parity; "threefry" uses
    # counter-based hashing (better distributed, still deterministic).
    rng: str = "reference"

    # Shading constants (fragment_shader.glsl:110 ambient; :707-708 sky gradient;
    # :511 shadow iterations; :511,527 visibility floor).
    ambient: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    sky_horizon: Tuple[float, float, float] = (0.15, 0.25, 0.45)
    sky_zenith: Tuple[float, float, float] = (0.5, 0.7, 1.0)
    shadow_max_iters: int = 32
    shadow_min_visibility: float = 0.05

    # Extension over the reference: progressive accumulation across frames
    # (the reference hardcodes 1 spp with no history; SURVEY.md §7 flags this
    # as a deliberate extension).
    accumulate: bool = False

    # Traversal backend. "auto" picks from the platform: on a GPU the
    # per-ray Pallas walk (ops/walk.py), on the CPU the XLA while_loop walk
    # (ops/traverse.py). "xla" and "walk" force one; "walk" on the CPU runs
    # the kernel in Pallas interpret mode (tests only).
    kernels: str = "auto"

    # Pixel-tile swizzle edge (0 = scanline order). Rays are traced in
    # tile x tile blocks so neighbouring rays in a wave, and so in one block
    # of the walk kernel, cover a compact screen region.
    packet_tile: int = 64

    # Debug overlays (fragment_shader.glsl uniforms :99-105).
    debug_show_lights: bool = False
    debug_show_bvh: bool = False
    debug_bvh_mode: int = 0  # 0 = TLAS, 1 = BLAS
    debug_selected_blas: int = 0
    debug_selected_tri: int = 0
    show_fps_overlay: bool = False

    # Per-chunk world-triangle budget for the chunked path
    # (bigscene.partition_scene); 0 = one tree. A single-device scene with
    # more world triangles than this is split into several trees.
    chunk_tris: int = 0

    # Automatic acceleration-structure maintenance: when an instance's
    # translation since the last topology build exceeds this fraction of the
    # scene's world diagonal, Renderer.update_transforms triggers
    # refresh_topology() — the on-demand analog of the reference's per-frame
    # TLAS rebuild (main.cpp:1192-1194), so traversal quality never decays
    # under sustained motion without paying a rebuild every frame. 0 disables.
    auto_refresh_drift: float = 0.25

    # Host-side knobs (not part of the jit key in practice, but harmless).
    cache_dir: str = ".rayzen_cache"
    log_level: str = "info"
    warmup_frames: int = 0
    path_tracer_only: bool = False
    rebuild_bvh: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_rays(self) -> int:
        return self.width * self.height
