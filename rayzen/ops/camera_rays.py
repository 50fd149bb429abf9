"""Primary-ray generation (the calculateRay kernel, fragment_shader.glsl:204-212).

NDC -> eye -> world unprojection using the camera's inverse projection/view
matrices, batched over all pixels. uv jitter comes from the active sampler.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import normalize


def pixel_grid(width: int, height: int):
    """Returns (frag, uv): gl_FragCoord.xy (pixel centers, +0.5) and uv in [0,1],
    both (H*W, 2) float32, row-major with y increasing upward like GL."""
    x = jnp.arange(width, dtype=jnp.float32) + 0.5
    y = jnp.arange(height, dtype=jnp.float32) + 0.5
    fx, fy = jnp.meshgrid(x, y, indexing="xy")  # (H, W)
    frag = jnp.stack([fx.ravel(), fy.ravel()], axis=-1)
    uv = frag / jnp.asarray([width, height], dtype=jnp.float32)
    return frag, uv


@functools.lru_cache(maxsize=32)
def tile_permutation(width: int, height: int, tile: int):
    """(perm, inv_perm) reordering the flat pixel axis into tile x tile blocks.

    The walk kernel (ops/walk.py) runs contiguous blocks of rays together and
    each block loops until its slowest ray ends; in scanline order a block is a
    1-pixel-high strip with poor spatial coherence, while a square tile shares
    most of its tree path. numpy, cached — this is static per resolution."""
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    blocks = []
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            blocks.append(idx[ty : ty + tile, tx : tx + tile].ravel())
    perm = np.concatenate(blocks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm, inv


def generate_rays(uv, jitter, inv_proj, inv_view, cam_position):
    """uv, jitter: (R, 2). Returns (origin (R, 3), direction (R, 3))."""
    uvj = uv + jitter
    ndc = uvj * 2.0 - 1.0  # (R, 2)
    clip = jnp.concatenate(
        [ndc, jnp.full_like(ndc[..., :1], -1.0), jnp.ones_like(ndc[..., :1])], axis=-1
    )
    # precision=highest: an accelerator may otherwise run these 4x4
    # unprojections in reduced precision (TF32 on a GPU), which bends primary
    # rays by ~1e-3 — visible against the f32 CPU goldens
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    eye = mm(clip, inv_proj.T)  # (R, 4)
    # ray_eye = (x, y, -1, 0)  (glsl:209)
    eye = jnp.concatenate(
        [eye[..., :2], jnp.full_like(eye[..., :1], -1.0), jnp.zeros_like(eye[..., :1])],
        axis=-1,
    )
    world = mm(eye, inv_view.T)[..., :3]
    direction = normalize(world)
    origin = jnp.broadcast_to(cam_position, direction.shape)
    return origin, direction
