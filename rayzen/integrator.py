"""Wavefront path-tracing integrator.

Reference: the megakernel main loop (fragment_shader.glsl:668-822) — per pixel:
primary ray, bounce loop (<= 5), TLAS/BLAS closest hit, GGX direct lighting on
bounce 0 only (:716), material-dependent scatter (deterministic dielectric
refraction with TIR fallback :723-747, stochastic reflect-vs-diffuse for opaque
:749-756), Russian roulette after bounce 2 (:764-769), sky gradient on miss
(:706-709), 1/n tone clamp (:772-773).

Rebuilt as a *wavefront*: the whole pixel wave advances bounce by bounce with
dense masked arithmetic — throughput/alive/current-IOR are (R,)-shaped state.
Bounce 0 is peeled (direct lighting happens only there); bounces 1..N-1 run in a
``lax.while_loop`` that exits when the wave dies. Traversal runs over the
unified world-space tree (packing.py) through one of the interchangeable
backends picked by ``select_kernels`` — the whole frame compiles to a small,
bounded program no matter the bounce budget or instance count.

Faithfully-kept reference quirks (SURVEY.md §7): throughput trims 0.95 (mirror),
0.98 (TIR), albedo*0.4 (diffuse); direct lighting only on bounce 0; the scatter
random draw is reused for Russian roulette (:720 vs :766); normals are geometric
and unflipped; `viewDir` is toward the camera position.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from . import material as mat_mod
from .config import RenderConfig
from .ops import camera_rays, rng as rng_mod, walk
from .ops.intersect import dot3, normalize
from .ops.shade import (
    direct_lighting,
    hemisphere_direction,
    reflect,
    refract_dir,
    sky_color,
)
from .ops.traverse import (
    brute_force_world,
    hit_shading_data,
    shadow_brute,
    shadow_walk,
    traverse_world,
)
from .packing import SceneArrays, WorldArrays, world_geometry


def select_kernels(cfg: RenderConfig, tracer: str = "bvh"):
    """Pick the (closest_hit, shadow) walks.

    ``kernels="auto"`` chooses from the platform: the per-ray Pallas walk
    (ops/walk.py) on a GPU, the XLA while_loop walk (ops/traverse.py) on the
    CPU; any other platform is an error. ``"xla"`` and ``"walk"`` force one;
    the walk runs in Pallas interpret mode only on the CPU (tests).
    tracer="brute" selects the BVH-free oracles."""
    if tracer == "brute":
        return brute_force_world, shadow_brute
    backend = jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise RuntimeError(f"no traversal walk for platform {backend!r}")
    kind = cfg.kernels
    if kind == "auto":
        kind = "walk" if backend == "gpu" else "xla"
    if kind == "xla":
        return traverse_world, shadow_walk
    if kind == "walk":
        interpret = backend == "cpu"
        return (
            partial(walk.closest_hit, interpret=interpret),
            partial(walk.shadow_walk, interpret=interpret),
        )
    raise ValueError(f"unknown kernels={cfg.kernels!r} (auto | xla | walk)")


def _make_sampler(cfg: RenderConfig, frag, uv, width, height, key: int):
    if cfg.rng == "reference":
        return rng_mod.ReferenceSampler(uv, frag)
    pixel_id = (frag[:, 1].astype(jnp.uint32) * jnp.uint32(width * 2)) + frag[
        :, 0
    ].astype(jnp.uint32)
    sampler = rng_mod.HashSampler(pixel_id, key=key)
    # HashSampler jitters a full pixel for AA; convert to uv units here.
    inv_res = jnp.asarray([1.0 / width, 1.0 / height], dtype=jnp.float32)
    base_jitter = sampler.camera_jitter

    def scaled_jitter():
        return base_jitter() * inv_res

    sampler.camera_jitter = scaled_jitter
    return sampler


def _scatter(direction, normal, material, cur_ior, rand_val, hemi_u, hemi_v):
    """Material-dependent scatter (glsl:722-756): deterministic dielectric
    refraction with TIR fallback, stochastic reflect-vs-diffuse for opaque.

    Returns (new_dir, throughput_factor (R, 3), new_ior)."""
    albedo = material[:, mat_mod.ALBEDO]
    reflectivity = material[:, mat_mod.REFLECTIVITY]
    transparency = material[:, mat_mod.TRANSPARENCY]
    mat_ior = material[:, mat_mod.IOR]
    is_trans = transparency > 0.0

    entering = dot3(-direction, normal) > 0.0
    n_out = jnp.where(entering[:, None], normal, -normal)
    ext_ior = cur_ior
    next_ior = jnp.where(entering, mat_ior, 1.0)
    eta = ext_ior / next_ior
    cosi = jnp.clip(dot3(-direction, n_out), 0.0, 1.0)
    f0 = ((ext_ior - next_ior) / (ext_ior + next_ior)) ** 2
    fresnel = f0 + (1.0 - f0) * (1.0 - cosi) ** 5
    refr, refr_ok = refract_dir(direction, n_out, eta)

    tir_case = is_trans & ~refr_ok
    refract_case = is_trans & refr_ok
    mirror_case = ~is_trans & (rand_val < reflectivity)

    refl_about_out = reflect(direction, n_out)  # TIR (glsl:736)
    refl_about_n = reflect(direction, normal)  # opaque mirror (glsl:751)
    diff_dir = hemisphere_direction(normal, hemi_u, hemi_v)

    new_dir = jnp.where(
        tir_case[:, None],
        refl_about_out,
        jnp.where(
            refract_case[:, None],
            refr,
            jnp.where(mirror_case[:, None], refl_about_n, diff_dir),
        ),
    )

    tint = (1.0 - transparency)[:, None] + albedo * transparency[:, None]
    transmit_w = jnp.clip(tint * (transparency * (1.0 - fresnel))[:, None], 0.0, 1.0)
    ones = jnp.ones_like(albedo)
    factor = jnp.where(
        tir_case[:, None],
        ones * 0.98,
        jnp.where(
            refract_case[:, None],
            transmit_w,
            jnp.where(mirror_case[:, None], ones * 0.95, albedo * 0.4),
        ),
    )
    new_ior = jnp.where(refract_case, next_ior, cur_ior)
    return new_dir, factor, new_ior


def trace_wave(
    ws: WorldArrays,
    origin,  # (R, 3)
    direction,  # (R, 3)
    cam_position,  # (3,)
    cfg: RenderConfig,
    sampler,
    samp: int,
    max_bounces: int,
    trace_fn,
    shadow_fn,
    active=None,
):
    """Trace one sample's wave to completion.

    Returns (radiance (R, 3), rays_traced ()) — the count covers every closest-
    hit query (primary + bounces) and every shadow re-cast, i.e. honest traced
    rays for Mrays/s reporting, not an upper bound.

    Structure: bounce 0 is peeled out (it alone does direct lighting + shadow
    rays, glsl:716), and bounces 1..N-1 run in a ``lax.while_loop`` that exits
    as soon as every ray is dead — so the compiled program contains exactly two
    instances of the closest-hit walk plus one shadow walk per light, keeping
    compile time flat in the bounce budget."""
    # all carries derive from `direction` so they are shard_map-varying
    color = direction * 0.0
    throughput = direction * 0.0 + 1.0
    alive = (
        (direction[:, 0] * 0.0 < 1.0) if active is None else active.astype(bool)
    )
    cur_ior = direction[:, 0] * 0.0 + 1.0  # medium tracking (glsl:674)

    def bounce_step(bounce, origin, direction, color, throughput, alive, cur_ior,
                    rays, with_lighting: bool):
        rays = rays + jnp.sum(alive.astype(jnp.int32))
        hit = trace_fn(ws, origin, direction, alive)
        missed = alive & ~hit.found
        color = color + jnp.where(
            missed[:, None], throughput * sky_color(direction, cfg), 0.0
        )
        alive = alive & hit.found
        normal, material, _ = hit_shading_data(ws, hit)

        if with_lighting:  # bounce 0 only (glsl:716)
            view_dir = normalize(cam_position - hit.point, eps=1e-20)
            direct, shadow_rays = direct_lighting(
                ws, hit.point, normal, material, view_dir, alive, cfg,
                shadow_fn=shadow_fn,
            )
            color = color + jnp.where(alive[:, None], throughput * direct, 0.0)
            rays = rays + shadow_rays

        rand_val, hemi_u, hemi_v = sampler.bounce_draws(samp, bounce)
        new_dir, factor, cur_ior = _scatter(
            direction, normal, material, cur_ior, rand_val, hemi_u, hemi_v
        )
        throughput = throughput * factor

        # self-intersection offset along the *geometric* normal, signed by the
        # new direction (glsl:758-761)
        push = jnp.where(dot3(new_dir, normal) > 0.0, 1.0, -1.0)
        origin = hit.point + normal * (push * 0.003)[:, None]
        direction = new_dir

        # ---- Russian roulette (glsl:764-769); reuses rand_val ----
        apply_rr = jnp.asarray(bounce, jnp.int32) > cfg.rr_start_bounce
        p = jnp.max(throughput, axis=-1)
        kill = apply_rr & (rand_val > p)
        alive = alive & ~kill
        throughput = jnp.where(
            apply_rr, throughput / jnp.maximum(p, 1e-12)[:, None], throughput
        )
        return origin, direction, color, throughput, alive, cur_ior, rays

    rays0 = jnp.sum(alive.astype(jnp.int32)) * 0  # varying-derived zero
    state = bounce_step(
        0, origin, direction, color, throughput, alive, cur_ior, rays0,
        with_lighting=True,
    )

    if max_bounces > 1:

        def cond(st):
            b = st[0]
            alive = st[5]
            return (b < max_bounces) & jnp.any(alive)

        def body(st):
            b = st[0]
            out = bounce_step(b, *st[1:], with_lighting=False)
            return (b + 1,) + out

        state = jax.lax.while_loop(cond, body, (jnp.int32(1),) + state)[1:]

    _, _, color, _, _, _, rays_traced = state
    return color, rays_traced


def render_world(
    ws: WorldArrays,
    frag,  # (R, 2) gl_FragCoord-style pixel coordinates
    uv,  # (R, 2) in [0, 1]
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: int,
    rng_key,
    trace_fn,
    shadow_fn,
    active=None,
):
    """Path-trace ``cfg.spp`` samples of a wave of pixels over one world;
    returns ((R, 3) clamped color, traced-ray count). Shared by the single-
    tree, chunked (bigscene.py) and deforming (deform.py) paths."""
    sampler = _make_sampler(cfg, frag, uv, cfg.width, cfg.height, rng_key)

    def one_sample(samp):
        if cfg.rng == "reference":
            # progressive keying: the sin-hash sampler is a pure function of
            # (pixel, sample index), so frame k continues at sample k*spp —
            # fresh samples per frame; key=0 reproduces the reference exactly.
            samp = jnp.asarray(samp, jnp.float32) + (
                jnp.asarray(rng_key, jnp.float32) * float(cfg.spp)
            )
        sampler.start_sample(samp)
        jitter = sampler.camera_jitter()
        origin, direction = camera_rays.generate_rays(
            uv,
            jitter,
            camera_params["inv_proj"],
            camera_params["inv_view"],
            camera_params["position"],
        )
        return trace_wave(
            ws,
            origin,
            direction,
            camera_params["position"],
            cfg,
            sampler,
            samp,
            max_bounces,
            trace_fn,
            shadow_fn,
            active=active,
        )

    total = jnp.zeros((frag.shape[0], 3), dtype=jnp.float32)
    rays_traced = jnp.int32(0)
    if cfg.spp <= 2:
        for samp in range(cfg.spp):
            radiance, rays = one_sample(samp)
            total = total + radiance
            rays_traced = rays_traced + rays
    else:
        # higher sample counts loop on device (constant program size; each
        # sample's computation is identical to the unrolled form)
        def body(samp, carry):
            total, rays_traced = carry
            radiance, rays = one_sample(samp)
            return total + radiance, rays_traced + rays

        total, rays_traced = jax.lax.fori_loop(
            0, cfg.spp, body, (total, rays_traced)
        )

    color = jnp.clip(total / float(cfg.spp), 0.0, 1.0)  # glsl:772-773
    return color, rays_traced


def render_rays(
    arrays: SceneArrays,
    frag,  # (R, 2) gl_FragCoord-style pixel coordinates
    uv,  # (R, 2) in [0, 1]
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key: int = 0,
    active=None,  # (R,) bool — padding rays in sharded renders are inactive
    with_stats: bool = False,
):
    """Path-trace an arbitrary wave of pixels; returns (R, 3) clamped color
    (and the traced-ray count when ``with_stats``).

    This is the shard-level entry: multi-device rendering runs exactly this
    function on each device's tile of rays (parallel.py)."""
    trace_fn, shadow_fn = select_kernels(cfg, tracer)
    ws = world_geometry(arrays)  # one refit per frame, shared by all waves
    color, rays_traced = render_world(
        ws, frag, uv, camera_params, cfg, max_bounces or cfg.max_bounces,
        rng_key, trace_fn, shadow_fn, active=active,
    )
    if with_stats:
        return color, rays_traced
    return color


def _swizzled_grid(cfg: RenderConfig):
    """Pixel grid in packet-coherent tile order; returns (frag, uv, inv_perm).
    inv_perm is None in scanline mode."""
    frag, uv = camera_rays.pixel_grid(cfg.width, cfg.height)
    if cfg.packet_tile <= 1:
        return frag, uv, None
    perm, inv = camera_rays.tile_permutation(
        cfg.width, cfg.height, cfg.packet_tile
    )
    return frag[perm], uv[perm], inv


def render_radiance(
    arrays: SceneArrays,
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key=0,
):
    """Render a full frame of radiance, (H, W, 3) float32 in [0, 1], bottom-up
    row order (GL convention). Single-chip hot path."""
    width, height = cfg.width, cfg.height
    frag, uv, inv = _swizzled_grid(cfg)
    color = render_rays(
        arrays, frag, uv, camera_params, cfg, max_bounces, tracer, rng_key
    )
    if inv is not None:
        color = color[inv]
    return color.reshape(height, width, 3)


def render_radiance_with_stats(
    arrays: SceneArrays,
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key=0,
):
    """Like render_radiance but also returns the traced-ray count (Mrays/s)."""
    frag, uv, inv = _swizzled_grid(cfg)
    color, rays = render_rays(
        arrays, frag, uv, camera_params, cfg, max_bounces, tracer, rng_key,
        with_stats=True,
    )
    if inv is not None:
        color = color[inv]
    return color.reshape(cfg.height, cfg.width, 3), rays
