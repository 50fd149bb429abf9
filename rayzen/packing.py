"""Scene -> device-array packing: the SSBO layer reimagined for HBM.

Reference: initializeSSBOs (RayZen/src/main.cpp:897-1120) builds 8 OpenGL SSBOs —
triangle soup, materials, lights, TLAS/BLAS node + index buffers, instances. Here
the same data becomes a ``SceneArrays`` pytree of jnp arrays: geometry, BVH nodes,
materials and lights are *data* leaves (uploaded once, replicated across chips),
while static layout (per-instance node/triangle offsets) is pytree metadata so jit
specializes on it.

Departures from the reference, by design (SURVEY.md §7):
- Shared meshes are packed once and instanced (the reference duplicates triangles
  and BLAS per GameObject in its soup, main.cpp:971-1007).
- Triangles are stored in BVH leaf order, so the per-BLAS index indirection buffer
  (blasTriIndices, fragment_shader.glsl:81-83) is gone: leaves reference
  contiguous triangle ranges.
- Triangles are stored as (v0, edge1, edge2) since Möller–Trumbore consumes edges
  (fragment_shader.glsl:392-393); v1/v2 are reconstructed only when needed.
- Instance world AABBs (transformed 8 corners of each BLAS root, main.cpp:975-993)
  are computed on device from the current transforms — no host TLAS re-upload per
  frame (the reference rebuilds + re-uploads everything each frame,
  main.cpp:1123-1208).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import logging_util as log
from .accel import native
from .accel.builder import BLAS, build_blas, build_tlas
from .config import RenderConfig
from .light import pack_lights
from .material import pack_materials
from .scene import Scene

HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True, eq=True)
class InstanceMeta:
    """Static per-instance layout (the BVHInstance POD, RayZen/include/BVH.h:14-21,
    minus the dynamic transforms which live in SceneArrays.transforms)."""

    node_offset: int  # offset into the concatenated BLAS node arrays
    tri_offset: int  # offset into the global triangle soup (globalTriOffset)
    num_nodes: int
    num_triangles: int
    mesh_index: int  # which unique mesh this instance references


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneArrays:
    """Device-resident scene. All leaves are arrays; ``instance_meta`` is static."""

    # Triangle soup, BVH-leaf order (T >= 1).
    tri_v0: jax.Array  # (T, 3) f32
    tri_e1: jax.Array  # (T, 3) f32  (v1 - v0)
    tri_e2: jax.Array  # (T, 3) f32  (v2 - v0)
    tri_mat: jax.Array  # (T,) i32
    # Concatenated BLAS nodes (N >= 1).
    node_bounds: jax.Array  # (N, 6) f32 [bmin | bmax]
    node_meta: jax.Array  # (N, 3) i32 [left_first, count, miss]
    # Instances (I >= 1).
    transforms: jax.Array  # (I, 4, 4) f32 — dynamic, updated per frame
    inv_transforms: jax.Array  # (I, 4, 4) f32
    root_bmin: jax.Array  # (I, 3) f32 object-space BLAS root bounds
    root_bmax: jax.Array  # (I, 3) f32
    inst_mat_override: jax.Array  # (I,) i32 — per-instance material override,
    # -1 keeps the mesh's per-triangle materials (GameObject.material_override)
    # ---- unified world-space BVH (static topology, device-refit bounds) ----
    # The TLAS and every instance's BLAS are stitched into ONE threaded tree:
    # TLAS leaves point at their instance's BLAS root, and BLAS escape links
    # (-1) are remapped to the owning TLAS leaf's miss link. Traversal is then
    # a single world-space walk — no per-instance ray transforms, no scan over
    # instances. Topology is static; bounds/triangles are recomputed on device
    # from the current transforms each frame (world_geometry below).
    uni_meta: jax.Array  # (Nu, 3) i32 [left_or_first, count, miss], stitched
    blas_src: jax.Array  # (Nb,) i32 — source row in node_bounds per BLAS node
    blas_inst: jax.Array  # (Nb,) i32 — owning instance per BLAS node
    tlas_mask: jax.Array  # (Nt, I) bool — instances under each TLAS node
    wtri_src: jax.Array  # (Tw,) i32 — source row in tri_* per world triangle
    wtri_inst: jax.Array  # (Tw,) i32 — owning instance per world triangle
    node_leaf_tri: jax.Array  # (Nu, K) i32 — world-tri ids inlined per leaf
    # Shading tables.
    materials: jax.Array  # (M, 8) f32
    lights: jax.Array  # (L, 8) f32
    # Static layout.
    instance_meta: Tuple[InstanceMeta, ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    @property
    def num_instances(self) -> int:
        return len(self.instance_meta)

    @property
    def num_lights(self) -> int:
        return int(self.lights.shape[0])

    def with_transforms(self, transforms: np.ndarray) -> "SceneArrays":
        """Functional transform update for dynamic scenes: inverse matrices are
        recomputed host-side (cheap, I×4×4), geometry/BVH untouched."""
        transforms = np.asarray(transforms, dtype=np.float32)
        inv = np.linalg.inv(transforms.astype(np.float64)).astype(np.float32)
        t_dev, i_dev = jax.device_put((transforms, inv))  # one transfer
        return dataclasses.replace(
            self, transforms=t_dev, inv_transforms=i_dev
        )


_blas_cache: dict = {}

_BLAS_FIELDS = ("bounds_min", "bounds_max", "left_first", "count", "miss", "order")


def _blas_disk_path(mesh, cfg: RenderConfig) -> str:
    """Content-hash keyed per-mesh BLAS cache file. The reference keys its
    bvh_cache/v2/meshN.* files by scene position (main.cpp:951-969), so the
    same mesh rebuilt in another scene misses; hashing the vertex soup lets
    meshes reuse across scenes and configs."""
    import hashlib

    h = hashlib.sha1(mesh.vertices.tobytes()).hexdigest()[:20]
    return os.path.join(
        cfg.cache_dir, "blas", f"{h}_{cfg.leaf_size}_{cfg.split_method}.npz"
    )


def _mesh_blas(mesh, cfg: RenderConfig) -> BLAS:
    """Per-mesh BLAS with two cache tiers: an in-process memo (the reference
    memoizes in function-local statics, main.cpp:1128-1136) and a content-
    hashed disk cache (the bvh_cache/v2 analog, main.cpp:951-969)."""
    key = (id(mesh), mesh.num_triangles, cfg.leaf_size, cfg.split_method)
    blas = _blas_cache.get(key)
    if blas is not None:
        return blas
    path = _blas_disk_path(mesh, cfg) if mesh.num_triangles else None
    if path and not cfg.rebuild_bvh and os.path.exists(path):
        try:
            with np.load(path) as z:
                blas = BLAS(**{f: z[f] for f in _BLAS_FIELDS})
            _blas_cache[key] = blas
            return blas
        except Exception as e:  # corrupt cache -> rebuild
            log.error(f"BLAS cache load failed ({e}); rebuilding")
    # native C++ builder when available; identical output to the numpy one
    builder = native.build_blas if native.available() else build_blas
    blas = builder(mesh.vertices, cfg.leaf_size, cfg.split_method)
    _blas_cache[key] = blas
    if path:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp.npz"
            np.savez(tmp, **{f: getattr(blas, f) for f in _BLAS_FIELDS})
            os.replace(tmp, path)
        except Exception as e:
            log.error(f"BLAS cache write failed: {e}")
    return blas


def pack_scene(scene: Scene, cfg: RenderConfig | None = None) -> SceneArrays:
    """Pack and ship to the device (one batched transfer)."""
    return jax.device_put(pack_scene_host(scene, cfg))


def pack_scene_host(
    scene: Scene, cfg: RenderConfig | None = None
) -> SceneArrays:
    """Pack entirely host-side: the returned SceneArrays has numpy leaves
    (still a valid pytree — jit/device_put treat it like any other), so disk
    caches can persist it without a device readback."""
    cfg = cfg or RenderConfig()
    unique_meshes = []
    mesh_slot = {}
    for go in scene.game_objects:
        if id(go.mesh) not in mesh_slot:
            mesh_slot[id(go.mesh)] = len(unique_meshes)
            unique_meshes.append(go.mesh)

    tri_v0, tri_e1, tri_e2, tri_mat = [], [], [], []
    bounds_list, meta_list = [], []
    mesh_layout = []  # (node_offset, tri_offset, n_nodes, n_tris) per unique mesh
    node_off = tri_off = 0
    for mesh in unique_meshes:
        blas = _mesh_blas(mesh, cfg)
        verts = mesh.vertices[blas.order]  # leaf order
        mats = mesh.material_index[blas.order]
        tri_v0.append(verts[:, 0])
        tri_e1.append(verts[:, 1] - verts[:, 0])
        tri_e2.append(verts[:, 2] - verts[:, 0])
        tri_mat.append(mats)
        bounds_list.append(
            np.concatenate([blas.bounds_min, blas.bounds_max], axis=1)
        )
        meta_list.append(
            np.stack([blas.left_first, blas.count, blas.miss], axis=1)
        )
        mesh_layout.append((node_off, tri_off, blas.num_nodes, blas.num_triangles))
        node_off += blas.num_nodes
        tri_off += blas.num_triangles

    instance_meta = []
    transforms = []
    root_bmin, root_bmax = [], []
    mat_override = []
    for go in scene.game_objects:
        slot = mesh_slot[id(go.mesh)]
        n_off, t_off, n_nodes, n_tris = mesh_layout[slot]
        instance_meta.append(InstanceMeta(n_off, t_off, n_nodes, n_tris, slot))
        transforms.append(go.transform)
        root_bmin.append(bounds_list[slot][0, :3])
        root_bmax.append(bounds_list[slot][0, 3:])
        mat_override.append(getattr(go, "material_override", -1))

    def cat(parts, empty_shape, dtype):
        if not parts or sum(p.shape[0] for p in parts) == 0:
            return np.zeros((1,) + empty_shape, dtype=dtype)
        return np.concatenate(parts).astype(dtype)

    tri_v0 = cat(tri_v0, (3,), np.float32)
    tri_e1 = cat(tri_e1, (3,), np.float32)
    tri_e2 = cat(tri_e2, (3,), np.float32)
    tri_mat = cat(tri_mat, (), np.int32)
    node_bounds = cat(bounds_list, (6,), np.float32)
    node_meta = cat(meta_list, (3,), np.int32)

    if transforms:
        transforms = np.stack(transforms).astype(np.float32)
        inv_transforms = np.linalg.inv(transforms.astype(np.float64)).astype(np.float32)
        root_bmin = np.stack(root_bmin).astype(np.float32)
        root_bmax = np.stack(root_bmax).astype(np.float32)
        mat_override = np.asarray(mat_override, dtype=np.int32)
    else:
        transforms = np.eye(4, dtype=np.float32)[None]
        inv_transforms = transforms.copy()
        root_bmin = np.full((1, 3), np.finfo(np.float32).max, dtype=np.float32)
        root_bmax = -root_bmin
        mat_override = np.full((1,), -1, dtype=np.int32)

    uni = _build_unified(
        instance_meta, node_meta, transforms, root_bmin, root_bmax,
        leaf_k=cfg.leaf_size,
    )
    total_tris = sum(m.num_triangles for m in instance_meta)
    log.info(
        f"Packed scene: {len(unique_meshes)} unique meshes, "
        f"{len(instance_meta)} instances, {total_tris} instanced triangles, "
        f"{node_meta.shape[0]} BVH nodes, {uni['uni_meta'].shape[0]} unified nodes"
    )

    # Host-side (numpy-leaved) SceneArrays: callers that persist the pack
    # (cached_pack_scene) save these directly; pack_scene ships them to the
    # device in one batched device_put.
    return SceneArrays(
        uni_meta=uni["uni_meta"],
        blas_src=uni["blas_src"],
        blas_inst=uni["blas_inst"],
        tlas_mask=uni["tlas_mask"],
        wtri_src=uni["wtri_src"],
        wtri_inst=uni["wtri_inst"],
        node_leaf_tri=uni["node_leaf_tri"],
        tri_v0=tri_v0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_mat=tri_mat,
        node_bounds=node_bounds,
        node_meta=node_meta,
        transforms=transforms,
        inv_transforms=inv_transforms,
        root_bmin=root_bmin,
        root_bmax=root_bmax,
        inst_mat_override=mat_override,
        materials=pack_materials(scene.materials),
        lights=pack_lights(scene.lights),
        instance_meta=tuple(instance_meta),
    )


def _build_unified(
    instance_meta, node_meta, transforms, root_bmin, root_bmax, leaf_k: int = 4
):
    """Stitch TLAS + per-instance BLAS copies into one threaded tree (host,
    build-time; numpy). See SceneArrays field docs for the layout.

    TLAS *topology* is built once from the initial instance AABBs and kept
    static; per-frame motion only refits node bounds on device. (The reference
    instead rebuilds the TLAS from scratch every frame on the host and re-
    uploads it, main.cpp:1192-1207 — the fixed-topology refit is the device-side
    fix from SURVEY.md §7. Repack if instances drift far enough to degrade the
    topology's quality.)"""
    n_inst = len(instance_meta)
    nonempty = [i for i, m in enumerate(instance_meta) if m.num_triangles > 0]

    # leaf_k = records-inlined triangles per leaf; must cover cfg.leaf_size
    # (the builders never emit leaves bigger than that) so no leaf triangle is
    # silently dropped from the inlined tables. Reference leaf cap: BVH.cpp:115.

    if not nonempty:
        out = dict(
            uni_meta=np.asarray([[0, 0, -1]], dtype=np.int32),
            blas_src=np.zeros((0,), dtype=np.int32),
            blas_inst=np.zeros((0,), dtype=np.int32),
            tlas_mask=np.zeros((1, max(n_inst, 1)), dtype=bool),
            wtri_src=np.zeros((1,), dtype=np.int32),
            wtri_inst=np.zeros((1,), dtype=np.int32),
            node_leaf_tri=np.zeros((1, leaf_k), dtype=np.int32),
        )
        return out

    # initial world AABBs (8 transformed corners of each BLAS root)
    init_wmin, init_wmax = [], []
    for i in nonempty:
        corners = np.stack(
            [
                [root_bmin[i][0] if x == 0 else root_bmax[i][0],
                 root_bmin[i][1] if y == 0 else root_bmax[i][1],
                 root_bmin[i][2] if z == 0 else root_bmax[i][2]]
                for x in (0, 1) for y in (0, 1) for z in (0, 1)
            ]
        ).astype(np.float32)
        w = corners @ transforms[i][:3, :3].T + transforms[i][:3, 3]
        init_wmin.append(w.min(axis=0))
        init_wmax.append(w.max(axis=0))
    tlas = build_tlas(np.stack(init_wmin), np.stack(init_wmax))
    n_tlas = tlas.num_nodes

    # layout: world-triangle and unified-BLAS-node offsets per nonempty instance
    wtri_off, blas_off = {}, {}
    cum_t, cum_n = 0, n_tlas
    for i in nonempty:
        wtri_off[i] = cum_t
        blas_off[i] = cum_n
        cum_t += instance_meta[i].num_triangles
        cum_n += instance_meta[i].num_nodes

    uni_meta = np.zeros((cum_n, 3), dtype=np.int32)
    blas_src = np.zeros((cum_n - n_tlas,), dtype=np.int32)
    blas_inst = np.zeros((cum_n - n_tlas,), dtype=np.int32)
    tlas_mask = np.zeros((n_tlas, n_inst), dtype=bool)
    leaf_miss = {}  # instance id -> miss link of its TLAS leaf

    # TLAS section: internal nodes pass through; leaves descend into BLAS roots
    for j in range(n_tlas):
        count = int(tlas.count[j])
        miss = int(tlas.miss[j])
        if count < 0:  # internal
            uni_meta[j] = (int(tlas.left_first[j]), -1, miss)
        else:  # leaf, exactly one instance (BVH.cpp:204)
            inst = nonempty[int(tlas.order[int(tlas.left_first[j])])]
            uni_meta[j] = (blas_off[inst], -1, miss)
            leaf_miss[inst] = miss

    # descendant-instance masks for device-side TLAS bound refit
    # (iterative post-order: children before parents, then union upward)
    desc = [None] * n_tlas
    stack = [(0, False)]
    while stack:
        node, expanded = stack.pop()
        if int(tlas.count[node]) >= 0:
            inst = nonempty[int(tlas.order[int(tlas.left_first[node])])]
            desc[node] = [inst]
        elif not expanded:
            left = int(tlas.left_first[node])
            stack.append((node, True))
            stack.append((left, False))
            stack.append((left + 1, False))
        else:
            left = int(tlas.left_first[node])
            desc[node] = desc[left] + desc[left + 1]
        if desc[node] is not None:
            for i in desc[node]:
                tlas_mask[node, i] = True

    # BLAS sections: remap child/first/miss links into unified space
    wtri_src, wtri_inst = [], []
    node_leaf_tri = np.zeros((cum_n, leaf_k), dtype=np.int32)
    for i in nonempty:
        m = instance_meta[i]
        off = blas_off[i]
        rows = node_meta[m.node_offset : m.node_offset + m.num_nodes]
        for k, (left_first, count, miss) in enumerate(rows):
            new_miss = leaf_miss[i] if miss == -1 else off + int(miss)
            if count < 0:  # internal
                uni_meta[off + k] = (off + int(left_first), -1, new_miss)
            else:  # leaf: first indexes the world-triangle array
                if int(count) > leaf_k:
                    raise ValueError(
                        f"BVH leaf with {int(count)} triangles exceeds the "
                        f"inlined leaf capacity {leaf_k} (cfg.leaf_size)"
                    )
                first = wtri_off[i] + int(left_first)
                uni_meta[off + k] = (first, int(count), new_miss)
                for c in range(min(int(count), leaf_k)):
                    node_leaf_tri[off + k, c] = first + c
            blas_src[off + k - n_tlas] = m.node_offset + k
            blas_inst[off + k - n_tlas] = i
        wtri_src.extend(range(m.tri_offset, m.tri_offset + m.num_triangles))
        wtri_inst.extend([i] * m.num_triangles)

    return dict(
        uni_meta=uni_meta,
        blas_src=blas_src,
        blas_inst=blas_inst,
        tlas_mask=tlas_mask,
        wtri_src=np.asarray(wtri_src, dtype=np.int32),
        wtri_inst=np.asarray(wtri_inst, dtype=np.int32),
        node_leaf_tri=node_leaf_tri,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WorldArrays:
    """Per-frame world-space scene: what traversal/shading actually consume.

    Produced on device by ``world_geometry`` from SceneArrays + current
    transforms. Triangles are pre-transformed to world space and node bounds
    refit, so the hot loops do no matrix math and no per-instance logic; world-
    space t falls out of Möller–Trumbore directly (the reference recovers it as
    |worldHit - origin|, glsl:485 — geometrically identical)."""

    tri_v0: jax.Array  # (Tw, 3) f32 world space
    tri_e1: jax.Array  # (Tw, 3) f32
    tri_e2: jax.Array  # (Tw, 3) f32
    tri_mat: jax.Array  # (Tw,) i32
    tri_inst: jax.Array  # (Tw,) i32
    tri_nsign: jax.Array  # (Tw,) f32 — +-1: orientation of the owning
    # instance transform. World-space cross(e1, e2) flips under mirroring
    # (det < 0); the reference's inverse-transpose normal (glsl:489) does not,
    # so the sign restores parity for mirrored instances.
    # Packed per-node records: ONE row gather serves a whole traversal step.
    # Layout (f32): [0:3] bmin | [3:6] bmax | [6:9] float-encoded (left_first,
    # count, miss) | [9:9+9K] K leaf triangles as (v0, e1, e2) | [..+K]
    # per-triangle transparency | pad. Internal nodes carry zero triangles;
    # the count field masks the unused lanes.
    records: jax.Array  # (Nu, W) f32
    materials: jax.Array  # (M, 8) f32
    lights: jax.Array  # (L, 8) f32
    leaf_k: int = dataclasses.field(metadata=dict(static=True), default=4)
    @property
    def num_lights(self) -> int:
        return int(self.lights.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])


def world_geometry(arrays: SceneArrays) -> WorldArrays:
    """Refit the unified BVH and transform triangles to world space (device,
    inside jit, once per frame). Dense vectorized ops, cost ~O(T + N) — replaces
    the reference's per-frame host rebuild + full re-upload
    (updateDynamicBVHAndSSBOs, main.cpp:1123-1208)."""
    # triangles -> world space (edges use the rotation part only)
    src = arrays.wtri_src
    rot = arrays.transforms[arrays.wtri_inst][:, :3, :3]  # (Tw, 3, 3)
    trans = arrays.transforms[arrays.wtri_inst][:, :3, 3]
    # float32 products in full precision: a GPU may otherwise run them in
    # TF32 and move vertices by ~1e-3 relative
    v0 = jnp.einsum("tij,tj->ti", rot, arrays.tri_v0[src], precision=HIGHEST)
    v0 = v0 + trans
    e1 = jnp.einsum("tij,tj->ti", rot, arrays.tri_e1[src], precision=HIGHEST)
    e2 = jnp.einsum("tij,tj->ti", rot, arrays.tri_e2[src], precision=HIGHEST)
    # orientation sign per instance (mirroring flips cross products)
    inst_det = jnp.linalg.det(arrays.transforms[:, :3, :3])  # (I,)
    tri_nsign = jnp.where(inst_det[arrays.wtri_inst] < 0.0, -1.0, 1.0)

    # BLAS node bounds -> conservative world AABBs (8 transformed corners)
    b = arrays.node_bounds[arrays.blas_src]  # (Nb, 6) object space
    sel = jnp.asarray(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=jnp.float32,
    )
    corners = b[:, None, :3] * (1.0 - sel)[None] + b[:, None, 3:] * sel[None]
    m_rot = arrays.transforms[arrays.blas_inst][:, :3, :3]
    m_trans = arrays.transforms[arrays.blas_inst][:, :3, 3]
    wc = jnp.einsum("nij,nkj->nki", m_rot, corners, precision=HIGHEST)
    wc = wc + m_trans[:, None, :]
    blas_bounds = jnp.concatenate([wc.min(axis=1), wc.max(axis=1)], axis=-1)

    # TLAS node bounds from descendant instance AABBs (static masks)
    wmin, wmax = instance_world_aabbs(arrays)  # (I, 3)
    mask = arrays.tlas_mask[..., None]  # (Nt, I, 1)
    inf = jnp.float32(3.4e38)
    tmin = jnp.min(jnp.where(mask, wmin[None], inf), axis=1)
    tmax = jnp.max(jnp.where(mask, wmax[None], -inf), axis=1)
    tlas_bounds = jnp.concatenate([tmin, tmax], axis=-1)

    node_bounds = jnp.concatenate([tlas_bounds, blas_bounds], axis=0)  # (Nu, 6)

    # pack node records: bounds | meta | inlined leaf triangles | pad.
    # Meta ints are stored as float *values* (exact below 2^24), NOT bitcast:
    # -1 bitcast to f32 is a NaN payload, and NaN canonicalization anywhere on
    # the load path would corrupt the links.
    meta_f = arrays.uni_meta.astype(jnp.float32)  # (Nu, 3)
    tris9 = jnp.concatenate([v0, e1, e2], axis=1)  # (Tw, 9)
    leaf_block = tris9[arrays.node_leaf_tri]  # (Nu, K, 9)
    n_nodes, leaf_k = arrays.node_leaf_tri.shape
    leaf_block = leaf_block.reshape(n_nodes, leaf_k * 9)
    # per-leaf-triangle transparency (0 for opaque): lets the shadow kernels
    # accumulate transmission without a material lookup (shadowVisibility
    # semantics, glsl:517-523)
    # per-instance material override (-1 = keep the mesh's materials)
    ov = arrays.inst_mat_override[arrays.wtri_inst]
    tri_mat = jnp.where(ov >= 0, ov, arrays.tri_mat[src])
    wtri_transp = arrays.materials[tri_mat, 6]  # TRANSPARENCY column
    transp_block = wtri_transp[arrays.node_leaf_tri]  # (Nu, K)
    # per-leaf-triangle material id, sign-encoding the instance orientation:
    # enc = (mat + 1) * nsign — lets closest-hit kernels emit shading
    # attributes directly (no post-traversal gathers)
    wtri_mat_enc = (tri_mat.astype(jnp.float32) + 1.0) * tri_nsign
    mat_block = wtri_mat_enc[arrays.node_leaf_tri]  # (Nu, K)
    records = jnp.concatenate(
        [node_bounds, meta_f, leaf_block, transp_block, mat_block], axis=1
    )
    pad = (-records.shape[1]) % 8
    if pad:
        records = jnp.pad(records, ((0, 0), (0, pad)))

    return WorldArrays(
        tri_v0=v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_mat=tri_mat,
        tri_inst=arrays.wtri_inst,
        tri_nsign=tri_nsign.astype(jnp.float32),
        records=records,
        materials=arrays.materials,
        lights=arrays.lights,
        leaf_k=int(leaf_k),
    )


def instance_world_aabbs(arrays: SceneArrays):
    """World-space AABB per instance: transform the 8 corners of each BLAS root
    by the instance transform and rebound (main.cpp:975-993). Conservative and
    correct for affine transforms. Runs on device from current transforms."""
    bmin, bmax = arrays.root_bmin, arrays.root_bmax  # (I, 3)
    # (8, 3) selector of min/max per axis
    sel = jnp.asarray(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], dtype=jnp.float32
    )
    corners = bmin[:, None, :] * (1.0 - sel)[None] + bmax[:, None, :] * sel[None]
    # apply transform: (I, 4, 4) @ (I, 8, 4)
    r = jnp.einsum(
        "iab,ikb->ika", arrays.transforms[:, :3, :3], corners, precision=HIGHEST
    )
    w = r + arrays.transforms[:, None, :3, 3]
    # Empty meshes keep inverted root bounds here; traversal skips
    # zero-triangle instances statically so these boxes are never ray-tested.
    return w.min(axis=1), w.max(axis=1)


def build_scene_tlas(arrays: SceneArrays):
    """Host-side TLAS over current instance world AABBs (BVH::buildTLAS parity;
    used for the debug wireframe overlay and large-instance-count traversal)."""
    wmin, wmax = instance_world_aabbs(arrays)
    return build_tlas(np.asarray(wmin), np.asarray(wmax))
