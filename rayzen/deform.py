"""Deforming geometry: per-frame on-device LBVH rebuild, end to end.

Rigid motion needs only the device refit of a static topology
(packing.world_geometry); *deforming* meshes (fixed triangle count, vertices
moving arbitrarily — cloth, skinning, waves) invalidate topology itself. The
reference would rebuild its BVH on the host and re-upload (BVH.cpp:99,
main.cpp:1123-1208); here the whole pipeline stays on device and inside one
jit: world-space triangles -> Morton/Karras radix tree (accel/lbvh.py) ->
traversal tables -> path trace. No host round-trips, no recompilation across
frames (vertex positions are ordinary traced inputs).

Tables are built in the record layout the miss-link walks consume
(ops/traverse.py, ops/walk.py) with one triangle per leaf (leaf_k = 1). The
walks are stackless, so tree depth needs no guard.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .accel.lbvh import lbvh_for_triangles
from .config import RenderConfig
from .packing import WorldArrays


def world_from_deforming(
    tri_verts,  # (T, 3, 3) world-space vertices — traced, deforms per frame
    tri_mat,  # (T,) i32 material ids
    materials,  # (M, 8) f32
    lights,  # (L, 8) f32
):
    """Build a complete WorldArrays from deforming world-space triangles with
    an on-device LBVH — jit-compatible, topology rebuilt every call."""
    n = tri_verts.shape[0]
    lb = lbvh_for_triangles(tri_verts)
    order = lb["order"]  # leaf j holds triangle order[j]

    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    tris9 = jnp.concatenate([v0, e1, e2], axis=1)  # (T, 9)
    transp = materials[tri_mat, 6]  # TRANSPARENCY column
    menc = tri_mat.astype(jnp.float32) + 1.0  # world verts: orientation +1

    total = 2 * n - 1
    node_is_leaf = jnp.arange(total) >= (n - 1)
    bounds = jnp.concatenate([lb["bounds_min"], lb["bounds_max"]], axis=1)

    # ---- records (miss-link walk): [bounds|meta|tri9|transp|menc] ----
    leaf_tri = jnp.where(
        node_is_leaf, order[jnp.clip(jnp.arange(total) - (n - 1), 0, n - 1)], 0
    )
    first = jnp.where(node_is_leaf, leaf_tri, lb["left_first"])
    meta_f = jnp.stack(
        [first.astype(jnp.float32),
         lb["count"].astype(jnp.float32),
         lb["miss"].astype(jnp.float32)],
        axis=1,
    )
    records = jnp.concatenate(
        [bounds, meta_f, tris9[leaf_tri], transp[leaf_tri][:, None],
         menc[leaf_tri][:, None]],
        axis=1,
    )
    pad = (-records.shape[1]) % 8
    if pad:
        records = jnp.pad(records, ((0, 0), (0, pad)))

    return WorldArrays(
        tri_v0=v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_mat=tri_mat,
        tri_inst=jnp.zeros((n,), jnp.int32),
        tri_nsign=jnp.ones((n,), jnp.float32),
        records=records,
        materials=materials,
        lights=lights,
        leaf_k=1,
    )


def render_deforming(
    tri_verts,  # (T, 3, 3) traced world-space vertices
    tri_mat,  # (T,) i32
    materials,  # (M, 8)
    lights,  # (L, 8)
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    rng_key: int = 0,
    with_stats: bool = False,
):
    """Path-trace deforming geometry: LBVH rebuild + render, one jit, over
    the walks ``select_kernels`` picks."""
    from .integrator import _swizzled_grid, render_world, select_kernels

    ws = world_from_deforming(tri_verts, tri_mat, materials, lights)
    trace_fn, shadow_fn = select_kernels(cfg)
    frag, uv, inv = _swizzled_grid(cfg)
    color, rays_traced = render_world(
        ws, frag, uv, camera_params, cfg, max_bounces or cfg.max_bounces,
        rng_key, trace_fn, shadow_fn,
    )
    if inv is not None:
        color = color[inv]
    img = color.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, rays_traced
    return img
