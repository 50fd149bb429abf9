"""Multi-device rendering: pixel tiles sharded over a device mesh.

The reference's only parallelism is per-pixel SIMT on one GPU (SURVEY.md §2,
"Parallelism & communication"). Across devices: shard the flattened pixel/ray
axis across a 1-D `jax.sharding.Mesh` with `shard_map` — the scene
(triangles, BVH, materials, lights) is replicated to every device (it's small,
like globally-visible SSBOs), each device path-traces its contiguous tile of
rays fully locally, and the framebuffer assembles via the output sharding (an
all-gather only if a replicated result is requested).

`shard_map` (not bare GSPMD jit) matters here: the traversal/shadow loops run
*per shard*, so each device iterates only until its own rays finish instead
of synchronizing a global `any()` across devices every tree step.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .config import RenderConfig
from .integrator import render_rays
from .ops import camera_rays
from .packing import SceneArrays

AXIS = "tiles"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.asarray(devices[:n]), (AXIS,))


def _pad_to_multiple(x, m: int):
    r = x.shape[0] % m
    if r == 0:
        return x
    pad = [(0, m - r)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def render_radiance_sharded(
    arrays: SceneArrays,
    camera_params: dict,
    cfg: RenderConfig,
    mesh: Mesh,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key: int = 0,
    with_stats: bool = False,
):
    """Full-frame render with the ray axis sharded over ``mesh``. Returns the
    (H, W, 3) frame (replicated), plus the aggregate traced-ray count (a psum
    over devices — honest Mrays/s for sharded renders) when ``with_stats``.
    Wrap in jit with the mesh in scope."""
    width, height = cfg.width, cfg.height
    n_dev = mesh.devices.size
    frag, uv = camera_rays.pixel_grid(width, height)
    inv = None
    if cfg.packet_tile > 1:
        perm, inv = camera_rays.tile_permutation(width, height, cfg.packet_tile)
        frag, uv = frag[perm], uv[perm]
    n_rays = frag.shape[0]
    frag_p = _pad_to_multiple(frag, n_dev)
    uv_p = _pad_to_multiple(uv, n_dev)
    active = _pad_to_multiple(jnp.ones((n_rays,), dtype=bool), n_dev)

    def tile_fn(arrays_rep, cam_rep, frag_sh, uv_sh, active_sh):
        color, rays = render_rays(
            arrays_rep,
            frag_sh,
            uv_sh,
            cam_rep,
            cfg,
            max_bounces=max_bounces,
            tracer=tracer,
            rng_key=rng_key,
            active=active_sh,
            with_stats=True,
        )
        return color, jax.lax.psum(rays, AXIS)

    # check_vma=False: pallas_call out_shapes carry no varying-axis metadata,
    # so the vma checker rejects kernels inside shard_map; collectives here are
    # explicit (one psum) and every other output is per-shard by construction.
    color, rays = jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P()),
        check_vma=False,
    )(arrays, camera_params, frag_p, uv_p, active)

    color = color[:n_rays]
    if inv is not None:
        color = color[inv]
    color = color.reshape(height, width, 3)
    if with_stats:
        return color, rays
    return color


def jit_sharded_renderer(arrays, cfg: RenderConfig, mesh: Mesh, **kw):
    """Returns a jitted (arrays, camera_params) -> frame closure over ``mesh``."""

    @jax.jit
    def fn(arrays_, camera_params):
        return render_radiance_sharded(arrays_, camera_params, cfg, mesh, **kw)

    return fn
