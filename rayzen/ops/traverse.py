"""Wavefront TLAS/BLAS traversal in plain XLA: the CPU path and the reference
the GPU walk kernel (ops/walk.py) is tested against.

Reference: traverseTLAS / traverseBLAS (fragment_shader.glsl:419-503) — per-pixel
stack-based (int stack[64]) tree walks inside a divergent megakernel. This module
restructures it as a lockstep wavefront (SURVEY.md §7):

- Traversal is *stackless*: nodes carry precomputed miss links
  (accel/builder.py), so each ray's traversal state is one int. All rays advance in
  lockstep inside a single ``lax.while_loop``; finished rays (cur == -1) idle under
  masks until every ray in the wave is done.
- The two-level TLAS/BLAS structure is *stitched into one world-space tree* at
  pack time (packing._build_unified): TLAS leaves link to their BLAS root, BLAS
  escape links continue at the TLAS level. Bounds are refit and triangles
  pre-transformed to world space on device each frame (packing.world_geometry),
  so the per-ray loop does no matrix math, no per-instance sweeps, and runs
  exactly one while_loop per wave — the iteration count is a single tree walk
  rather than instances x tree walks.
  World-space t falls out of Möller–Trumbore directly; the reference recovers
  the same quantity as |worldHit - origin| (glsl:485). Pruning `tmin > tHit`
  (glsl:430/468) carries over unchanged.

Node/triangle fetches are row gathers; leaf triangle tests are unrolled
``leaf_size`` wide (leaf size <= 4, BVH.cpp:115) and masked by the leaf's
actual count.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..packing import SceneArrays, WorldArrays, world_geometry
from .intersect import T_FAR, face_normal, moller_trumbore, slab_test


def _safe_inv_dir(direction):
    """Huge-but-finite reciprocal (the walk kernel in ops/walk.py uses the
    same rule): avoids the 0 * inf NaNs a plain 1/d produces
    for axis-parallel rays with an origin on a slab plane — keeping the whole
    path clean under jax_debug_nans. t values for degenerate axes become ~1e30
    instead of inf; comparisons behave identically."""
    return jnp.where(direction >= 0.0, 1.0, -1.0) / jnp.maximum(
        jnp.abs(direction), 1e-30
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Hit:
    """Closest-hit record for a wave of rays, with the shading attributes of
    the winning triangle (filled by ``_resolve_hit``)."""

    t: jax.Array  # (R,) world-space distance, T_FAR if none
    point: jax.Array  # (R, 3) world-space hit point
    tri: jax.Array  # (R,) global triangle index, -1 if none
    inst: jax.Array  # (R,) instance index, -1 if none
    found: jax.Array  # (R,) bool
    normal: jax.Array  # (R, 3) unit world geometric normal (orientation-
    # corrected for mirrored instances; unflipped toward the ray, glsl:411)
    mat: jax.Array  # (R,) material index, -1 if none

    @property
    def num_rays(self) -> int:
        return int(self.t.shape[0])


def traverse_blas(
    arrays: SceneArrays,
    origin,  # (R, 3) object space
    direction,  # (R, 3) object space, normalized
    active,  # (R,) bool
    node_offset: int,
    tri_offset: int,
    leaf_size: int = 4,
):
    """Stackless BLAS walk. Returns (t_local (R,), tri (R,) global index or -1)."""
    inv_dir = _safe_inv_dir(direction)
    cur0 = jnp.where(active, 0, -1).astype(jnp.int32)
    # derive loop carries from ``direction`` (data-dependence, not just shape)
    # so they inherit shard_map varying-ness; ``origin`` can be an unvarying
    # broadcast of the camera position, ``direction`` always varies per ray
    t0 = direction[:, 0] * 0.0 + jnp.float32(T_FAR)
    tri0 = cur0 * 0 - 1

    def cond(state):
        cur, _, _ = state
        return jnp.any(cur >= 0)

    def body(state):
        cur, t_best, tri_best = state
        alive = cur >= 0
        idx = node_offset + jnp.maximum(cur, 0)
        bounds = arrays.node_bounds[idx]  # (R, 6) row gather
        meta = arrays.node_meta[idx]  # (R, 3) row gather
        tmin, _, box_hit = slab_test(origin, inv_dir, bounds[:, :3], bounds[:, 3:])
        # prune when the box entry is beyond the best hit (glsl:430)
        box_ok = alive & box_hit & (tmin <= t_best)
        left_first = meta[:, 0]
        count = meta[:, 1]
        miss = meta[:, 2]
        # internal nodes have count == -1; count == 0 is the empty-mesh root
        # leaf, which must fall through to the miss link, not descend
        is_leaf = count >= 0
        leaf_ok = box_ok & is_leaf
        base = tri_offset + left_first
        for k in range(leaf_size):
            lane = leaf_ok & (k < count)
            tid = base + k  # contiguous leaf range (triangles in leaf order)
            t, h = moller_trumbore(
                origin,
                direction,
                arrays.tri_v0[tid],
                arrays.tri_e1[tid],
                arrays.tri_e2[tid],
            )
            better = lane & h & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, tid, tri_best)
        nxt = jnp.where(box_ok & ~is_leaf, left_first, miss)
        cur = jnp.where(alive, nxt, cur)
        return cur, t_best, tri_best

    _, t_best, tri_best = jax.lax.while_loop(cond, body, (cur0, t0, tri0))
    return t_best, tri_best


def _unpack_record(rec, leaf_k):
    """Split a gathered (R, W) node-record batch into its fields. Meta ints are
    float-encoded values (see packing.world_geometry), exact below 2^24."""
    bmin = rec[:, 0:3]
    bmax = rec[:, 3:6]
    meta = rec[:, 6:9].astype(jnp.int32)
    tris = rec[:, 9 : 9 + 9 * leaf_k].reshape(rec.shape[0], leaf_k, 9)
    return bmin, bmax, meta[:, 0], meta[:, 1], meta[:, 2], tris


def traverse_world(
    ws: WorldArrays,
    origin,  # (R, 3) world space
    direction,  # (R, 3) world space, normalized
    active,  # (R,) bool
) -> Hit:
    """Closest hit over the unified world-space tree (traverseTLAS semantics,
    glsl:457-503, but with the two levels stitched into one stackless walk —
    no per-instance ray transforms, one while_loop per wave regardless of
    instance count or scene size). One (R, W) record gather per step feeds the
    box test AND the (inlined) leaf triangle tests."""
    inv_dir = _safe_inv_dir(direction)
    cur0 = jnp.where(active, 0, -1).astype(jnp.int32)
    t0 = direction[:, 0] * 0.0 + jnp.float32(T_FAR)
    tri0 = cur0 * 0 - 1
    leaf_k = ws.leaf_k

    def cond(state):
        return jnp.any(state[0] >= 0)

    def body(state):
        cur, t_best, tri_best = state
        alive = cur >= 0
        rec = ws.records[jnp.maximum(cur, 0)]  # single gather per step
        bmin, bmax, left_first, count, miss, tris = _unpack_record(rec, leaf_k)
        tmin, _, box_hit = slab_test(origin, inv_dir, bmin, bmax)
        box_ok = alive & box_hit & (tmin <= t_best)  # prune (glsl:430/468)
        is_leaf = count >= 0  # count==-1 internal; 0 = empty-scene leaf
        leaf_ok = box_ok & is_leaf
        for k in range(leaf_k):
            lane = leaf_ok & (k < count)
            t, h = moller_trumbore(
                origin, direction,
                tris[:, k, 0:3], tris[:, k, 3:6], tris[:, k, 6:9],
            )
            better = lane & h & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, left_first + k, tri_best)
        nxt = jnp.where(box_ok & ~is_leaf, left_first, miss)
        cur = jnp.where(alive, nxt, cur)
        return cur, t_best, tri_best

    _, t_best, tri_best = jax.lax.while_loop(cond, body, (cur0, t0, tri0))
    return _resolve_hit(ws, origin, direction, t_best, tri_best)


def _resolve_hit(ws: WorldArrays, origin, direction, t_best, tri_best) -> Hit:
    """Fill a Hit from (t, winning tri): point, instance, oriented normal,
    material — one batch of row gathers at wave end."""
    found = tri_best >= 0
    point = origin + direction * t_best[:, None]
    tid = jnp.maximum(tri_best, 0)
    inst = jnp.where(found, ws.tri_inst[tid], -1)
    n = face_normal(ws.tri_e1[tid], ws.tri_e2[tid]) * ws.tri_nsign[tid][:, None]
    mat = jnp.where(found, ws.tri_mat[tid], -1)
    return Hit(
        t=t_best, point=point, tri=tri_best, inst=inst, found=found,
        normal=n, mat=mat,
    )


def shadow_walk(
    ws: WorldArrays,
    origin,  # (R, 3)
    direction,  # (R, 3) toward the light, normalized
    max_dist,  # (R,)
    active,  # (R,) bool
    min_visibility: float = 0.05,
    t_eps: float = 1e-3,
):
    """Transmission-accumulating occlusion walk (shadowVisibility semantics,
    glsl:507-528) in a SINGLE tree traversal.

    The reference re-casts a closest-hit query from each transparent surface (up
    to 32 traversals per shadow ray). The transmission product over blockers is
    order-independent, so one walk that multiplies ``visibility`` by each
    intersected surface's transparency (0 for opaque) within (t_eps, max_dist)
    computes the same answer — opaque blocker => 0, early-kill below the
    ``min_visibility`` floor (glsl:511) folds into the traversal mask.

    Returns (visibility (R,), rays ()): rays counts occlusion queries issued
    (one per active ray), the honest unit for Mrays/s.

    Known measure-zero deviation from the reference: a ray passing exactly
    through the shared edge of two coplanar transparent triangles multiplies
    both (the reference's closest-hit restart counts the surface once).
    """
    inv_dir = _safe_inv_dir(direction)
    cur0 = jnp.where(active, 0, -1).astype(jnp.int32)
    vis0 = direction[:, 0] * 0.0 + 1.0
    leaf_k = ws.leaf_k

    def cond(state):
        return jnp.any(state[0] >= 0)

    def body(state):
        cur, vis = state
        alive = cur >= 0
        rec = ws.records[jnp.maximum(cur, 0)]
        bmin, bmax, left_first, count, miss, tris = _unpack_record(rec, leaf_k)
        tmin, _, box_hit = slab_test(origin, inv_dir, bmin, bmax)
        box_ok = alive & box_hit & (tmin <= max_dist)
        is_leaf = count >= 0
        leaf_ok = box_ok & is_leaf
        for k in range(leaf_k):
            lane = leaf_ok & (k < count)
            t, h = moller_trumbore(
                origin, direction,
                tris[:, k, 0:3], tris[:, k, 3:6], tris[:, k, 6:9],
            )
            blocking = lane & h & (t >= t_eps) & (t < max_dist)
            transp = ws.materials[ws.tri_mat[left_first + k], 6]  # TRANSPARENCY
            factor = jnp.where(transp > 0.0, transp, 0.0)
            vis = jnp.where(blocking, vis * factor, vis)
        # early kill below the visibility floor (glsl:511)
        dead = vis <= min_visibility
        nxt = jnp.where(box_ok & ~is_leaf, left_first, miss)
        cur = jnp.where(alive & ~dead, nxt, jnp.where(dead, -1, cur))
        return cur, vis

    _, vis = jax.lax.while_loop(cond, body, (cur0, vis0))
    rays = jnp.sum(active.astype(jnp.int32))
    return vis, rays


def shadow_brute(
    ws: WorldArrays,
    origin,
    direction,
    max_dist,
    active,
    min_visibility: float = 0.05,
    t_eps: float = 1e-3,
):
    """BVH-free oracle for shadow_walk: product of transmission over every
    world triangle intersected within range."""
    t, h = moller_trumbore(
        origin[:, None, :],
        direction[:, None, :],
        ws.tri_v0[None, :, :],
        ws.tri_e1[None, :, :],
        ws.tri_e2[None, :, :],
    )
    blocking = h & (t >= t_eps) & (t < max_dist[:, None])
    transp = ws.materials[ws.tri_mat, 6][None, :]  # (1, Tw)
    factor = jnp.where(transp > 0.0, transp, 0.0)
    vis = jnp.prod(jnp.where(blocking, factor, 1.0), axis=1)
    vis = jnp.where(active, vis, 1.0)
    rays = jnp.sum(active.astype(jnp.int32))
    return vis, rays


def material_rows(ws: WorldArrays, mat_idx):
    """(R, 8) material rows for per-ray indices. For small tables (the normal
    case) this unrolls a select chain over the static material list instead of
    issuing a gather; the select chain fuses into the surrounding elementwise
    work (ROADMAP S5: re-tune on the card)."""
    n_mats = int(ws.materials.shape[0])
    if n_mats > 32:
        return ws.materials[mat_idx]
    row = jnp.zeros((mat_idx.shape[0], ws.materials.shape[1]), jnp.float32)
    for m in range(n_mats):
        row = jnp.where((mat_idx == m)[:, None], ws.materials[m], row)
    return row


def hit_shading_data(ws: WorldArrays, hit: Hit):
    """(world normal, material row, mat idx) for a resolved Hit. The normal is
    the oriented geometric normal — exactly the reference's inverse-transpose
    rule (glsl:489-490), mirrored instances included; NOT flipped toward the
    ray (glsl:411). The geometric attributes ride on the Hit."""
    mat_idx = jnp.maximum(hit.mat, 0)
    return hit.normal, material_rows(ws, mat_idx), mat_idx


def brute_force_world(ws: WorldArrays, origin, direction, active) -> Hit:
    """BVH-free oracle: intersect every world-space triangle.

    This is the ground truth the reference never had (SURVEY.md §4) — used by
    the golden-image tests to validate the BVH path."""
    t, h = moller_trumbore(
        origin[:, None, :],
        direction[:, None, :],
        ws.tri_v0[None, :, :],
        ws.tri_e1[None, :, :],
        ws.tri_e2[None, :, :],
    )
    t = jnp.where(h, t, T_FAR)
    k = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t, k[:, None], axis=1)[:, 0]
    found = active & (t_best < T_FAR)
    t_best = jnp.where(found, t_best, T_FAR)
    tri = jnp.where(found, k, -1)
    return _resolve_hit(ws, origin, direction, t_best, tri)


# -- SceneArrays-level conveniences (tests, interactive use) -----------------


def traverse_scene(arrays: SceneArrays, origin, direction, active) -> Hit:
    """Refit to world space, then traverse. Hot paths should call
    world_geometry once per frame and use traverse_world directly."""
    return traverse_world(world_geometry(arrays), origin, direction, active)


def brute_force_scene(arrays: SceneArrays, origin, direction, active) -> Hit:
    return brute_force_world(world_geometry(arrays), origin, direction, active)
