"""Chunked scenes: one scene split into several world-space trees.

A scene set to chunk (``RenderConfig.chunk_tris``) is *partitioned* into
chunks of at most ``chunk_tris`` world triangles; every chunk gets its own
unified world-space BVH (the existing packing machinery, unchanged), and per
wave the integrator walks each chunk's tree with the selected closest-hit
walk, merging closest hits elementwise (shadow queries multiply per-chunk
transmission — order-independent, ops/traverse.shadow_walk's argument).

Partitioning: whole instances are packed greedily into chunks; a single mesh
too big for one chunk is split into Morton-ordered triangle runs (spatially
compact sub-meshes) that share the owning instance's transform. Lights,
materials, and camera replicate into every chunk.
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from . import logging_util as log
from .config import RenderConfig
from .mesh import Mesh
from .scene import GameObject, Scene

def _morton3(cent: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (T, 3) centroids (host, numpy)."""
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip(((cent - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (
        (spread(q[:, 0]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 2])
    )


def split_mesh(mesh: Mesh, max_tris: int) -> List[Mesh]:
    """Split an oversized mesh into Morton-ordered triangle runs — each run is
    spatially compact, so per-run BVH quality stays close to the whole-mesh
    build."""
    t = mesh.num_triangles
    if t <= max_tris:
        return [mesh]
    order = np.argsort(_morton3(mesh.vertices.mean(axis=1)), kind="stable")
    parts = []
    for s in range(0, t, max_tris):
        idx = order[s : s + max_tris]
        parts.append(
            Mesh(
                vertices=mesh.vertices[idx],
                material_index=mesh.material_index[idx],
            )
        )
    return parts


def partition_scene(scene: Scene, max_tris: int) -> List[Scene]:
    """Partition into chunk scenes of <= max_tris *world* (instanced)
    triangles each. Returns [scene] unchanged when it already fits."""
    total = sum(go.mesh.num_triangles for go in scene.game_objects)
    if total <= max_tris:
        return [scene]

    # explode oversized meshes once (shared across their instances); each
    # exploded object remembers which original scene.game_objects index it
    # came from so transform updates can be routed back (origin_indices below)
    split_cache: dict = {}
    exploded: List[GameObject] = []
    exploded_origin: List[int] = []
    for oi, go in enumerate(scene.game_objects):
        if go.mesh.num_triangles > max_tris:
            if id(go.mesh) not in split_cache:
                split_cache[id(go.mesh)] = split_mesh(go.mesh, max_tris)
            for part in split_cache[id(go.mesh)]:
                exploded.append(
                    GameObject(
                        mesh=part, transform=go.transform, name=go.name,
                        material_override=go.material_override,
                    )
                )
                exploded_origin.append(oi)
        else:
            exploded.append(go)
            exploded_origin.append(oi)

    # greedy bin-packing of instances in spatial (transform-origin Morton)
    # order so chunks stay spatially coherent
    origins = np.stack([np.asarray(go.transform)[:3, 3] for go in exploded])
    order = np.argsort(_morton3(origins), kind="stable")
    chunks: List[List[GameObject]] = [[]]
    chunk_origins: List[List[int]] = [[]]
    load = 0
    for i in order:
        go = exploded[int(i)]
        n = go.mesh.num_triangles
        if load and load + n > max_tris:
            chunks.append([])
            chunk_origins.append([])
            load = 0
        chunks[-1].append(go)
        chunk_origins[-1].append(exploded_origin[int(i)])
        load += n

    out = []
    for part, part_origins in zip(chunks, chunk_origins):
        s = Scene(camera=scene.camera, materials=scene.materials,
                  lights=scene.lights, game_objects=part)
        # per-chunk map: instance slot -> original scene.game_objects index
        # (split-mesh parts repeat their owner's index). Renderer.
        # update_transforms uses this to route a full (I, 4, 4) stack indexed
        # by the ORIGINAL scene order into each chunk's transform slots.
        s.origin_indices = np.asarray(part_origins, dtype=np.int64)
        out.append(s)

    # near-to-far from the camera, so the nearest chunks come first
    cam = np.asarray(scene.camera.position, np.float32)

    def cam_dist(s):
        origins = np.stack([np.asarray(g.transform)[:3, 3] for g in s.game_objects])
        return float(np.linalg.norm(origins.mean(axis=0) - cam))

    out.sort(key=cam_dist)
    log.info(
        f"Partitioned scene: {total} world triangles -> {len(out)} chunks "
        f"(<= {max_tris} each)"
    )
    return out


def merge_hits(a, b):
    """Elementwise closest-hit merge of two per-chunk Hit records."""
    from .ops.traverse import Hit

    better = b.found & (b.t < a.t)
    bm = better[:, None]
    return Hit(
        t=jnp.where(better, b.t, a.t),
        point=jnp.where(bm, b.point, a.point),
        tri=jnp.where(better, b.tri, a.tri),
        inst=jnp.where(better, b.inst, a.inst),
        found=a.found | b.found,
        normal=jnp.where(bm, b.normal, a.normal),
        mat=jnp.where(better, b.mat, a.mat),
    )


def render_radiance_chunked(
    arrays_list,  # List[SceneArrays], one per chunk
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    rng_key: int = 0,
    with_stats: bool = False,
):
    """Full-frame render over chunked trees: each wave walks every chunk's
    tree with the selected walk and merges the hits."""
    from .integrator import _swizzled_grid, render_world, select_kernels
    from .packing import world_geometry

    trace, shadow = select_kernels(cfg)
    ws_list = [world_geometry(a) for a in arrays_list]

    def trace_fn(_ws, origin, direction, active):
        hit = None
        for ws in ws_list:
            h = trace(ws, origin, direction, active)
            hit = h if hit is None else merge_hits(hit, h)
        return hit

    def shadow_fn(_ws, origin, direction, max_dist, active, **kw):
        min_vis = kw.get("min_visibility", cfg.shadow_min_visibility)
        vis_total, rays = None, None
        act = active
        for ws in ws_list:
            vis, r = shadow(ws, origin, direction, max_dist, act, **kw)
            vis_total = vis if vis_total is None else vis_total * vis
            # rays already extinguished skip the remaining chunk walks
            act = act & (vis_total > min_vis)
            rays = r if rays is None else rays  # one query per ray, not per chunk
        return vis_total, rays

    frag, uv, inv = _swizzled_grid(cfg)
    color, rays_traced = render_world(
        ws_list[0], frag, uv, camera_params, cfg,
        max_bounces or cfg.max_bounces, rng_key, trace_fn, shadow_fn,
    )
    if inv is not None:
        color = color[inv]
    img = color.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, rays_traced
    return img
