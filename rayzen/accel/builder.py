"""Host-side BVH builders.

Reference: RayZen/src/BVH.cpp —
- ``build_blas``: iterative binary BVH over a mesh's triangles with leaf size <= 4
  (BVH.cpp:115), sweep SAH split (per-axis centroid sort + prefix/suffix bounds +
  cost sweep, findSAHSplit BVH.cpp:22-97) and midpoint fallback when SAH is invalid
  (BVH.cpp:135-150). Split method selectable (BVHSplitMethod, BVH.h:23-26).
- ``build_tlas``: midpoint-split BVH over instance world AABBs, one instance per
  leaf (BVH.cpp:178-240).

Two departures from the reference layout, for device traversal:
1. Nodes carry a precomputed *miss link* so device traversal is stackless: a ray
   holds a single current-node index instead of a 64-entry stack
   (fragment_shader.glsl:422,461). hit -> descend to left child (right = left+1);
   miss (or leaf processed) -> jump to the miss link; -1 terminates.
2. ``build_blas`` returns the leaf-order permutation so callers can reorder the
   triangle soup itself; leaves then reference *contiguous* triangle ranges and the
   indirection buffer (blasTriIndices, fragment_shader.glsl:81-83) disappears.

This is the portable pure-numpy builder; rayzen.accel.native provides a C++
implementation of the same algorithm for large meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_INF = np.float32(np.finfo(np.float32).max)


@dataclasses.dataclass
class BLAS:
    """Flattened BVH. Internal nodes: count == -1, left_first = left child index
    (right child = left_first + 1). Leaves: count >= 0, left_first = first
    position in ``order`` (equivalently: first triangle of the reordered soup)."""

    bounds_min: np.ndarray  # (N, 3) f32
    bounds_max: np.ndarray  # (N, 3) f32
    left_first: np.ndarray  # (N,) i32
    count: np.ndarray  # (N,) i32
    miss: np.ndarray  # (N,) i32, -1 = traversal done
    order: np.ndarray  # (T,) i64 permutation: leaf position -> original tri index

    @property
    def num_nodes(self) -> int:
        return int(self.left_first.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.order.shape[0])

    @property
    def root_bounds(self) -> tuple:
        return self.bounds_min[0].copy(), self.bounds_max[0].copy()


# TLAS has the same flattened shape; ``order`` maps leaf position -> instance id.
TLAS = BLAS


def _tri_bounds(verts: np.ndarray):
    """verts (T, 3, 3) -> per-triangle AABB (T, 3), (T, 3)."""
    return verts.min(axis=1), verts.max(axis=1)


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = bmax - bmin
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def _sah_split(order_slice, centroids, tmin, tmax, parent_area):
    """Sweep SAH over all 3 axes (findSAHSplit, BVH.cpp:22-97).

    Returns (best_axis, best_split, sorted_order) or (None, None, None)."""
    n = order_slice.shape[0]
    best_cost = np.inf
    best_axis, best_split, best_sorted = -1, -1, None
    for axis in range(3):
        sort_idx = np.argsort(centroids[order_slice, axis], kind="stable")
        sorted_order = order_slice[sort_idx]
        lo = tmin[sorted_order]  # (n, 3)
        hi = tmax[sorted_order]
        left_min = np.minimum.accumulate(lo, axis=0)
        left_max = np.maximum.accumulate(hi, axis=0)
        right_min = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
        right_max = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
        left_area = _surface_area(left_min[:-1], left_max[:-1])  # i = 1..n-1
        right_area = _surface_area(right_min[1:], right_max[1:])
        counts = np.arange(1, n, dtype=np.float64)
        cost = (left_area * counts + right_area * (n - counts)) / (parent_area + 1e-6)
        i = int(np.argmin(cost))
        if cost[i] < best_cost:
            best_cost = float(cost[i])
            best_axis = axis
            best_split = i + 1
            best_sorted = sorted_order
    if best_axis < 0:
        return None, None, None
    return best_axis, best_split, best_sorted


def _midpoint_partition(order_slice, centroids, bmin, bmax):
    """Longest-axis center split (BVH.cpp:137-150 and TLAS build :210-224):
    partition by centroid < center, degenerate -> split at count/2."""
    extent = bmax - bmin
    axis = 0
    if extent[1] > extent[0] and extent[1] > extent[2]:
        axis = 1
    elif extent[2] > extent[0]:
        axis = 2
    split = 0.5 * (bmin[axis] + bmax[axis])
    c = centroids[order_slice, axis]
    left_mask = c < split
    mid = int(left_mask.sum())
    n = order_slice.shape[0]
    if mid == 0 or mid == n:
        # keep original relative order, halve (BVH.cpp:149)
        mid = n // 2
        return order_slice.copy(), mid
    reordered = np.concatenate([order_slice[left_mask], order_slice[~left_mask]])
    return reordered, mid


def _build(
    tmin: np.ndarray,
    tmax: np.ndarray,
    centroids: np.ndarray,
    leaf_size: int,
    split_method: str,
    single_leaf: bool,
) -> BLAS:
    """Shared build core over primitive AABBs.

    ``single_leaf``: TLAS mode — leaves hold exactly one primitive (BVH.cpp:204).
    """
    n_prims = tmin.shape[0]
    if n_prims == 0:
        # Empty mesh: a single count-0 leaf with inverted bounds, matching the
        # reference's behavior for the missing car.obj (BVH.cpp:99-116 with 0
        # tris; main.cpp:371). NOTE: an inverted box acts as an everything-box
        # under min/max slab math (reference included) — the count-0 leaf is
        # what makes traversal a no-op.
        return BLAS(
            bounds_min=np.full((1, 3), _INF, dtype=np.float32),
            bounds_max=np.full((1, 3), -_INF, dtype=np.float32),
            left_first=np.zeros(1, dtype=np.int32),
            count=np.zeros(1, dtype=np.int32),
            miss=np.full(1, -1, dtype=np.int32),
            order=np.zeros(0, dtype=np.int64),
        )

    order = np.arange(n_prims, dtype=np.int64)
    nodes_bmin, nodes_bmax, nodes_lf, nodes_count = [], [], [], []

    def alloc():
        nodes_bmin.append(np.zeros(3, np.float32))
        nodes_bmax.append(np.zeros(3, np.float32))
        nodes_lf.append(0)
        nodes_count.append(0)
        return len(nodes_lf) - 1

    alloc()  # root
    stack = [(0, 0, n_prims)]
    while stack:
        nidx, start, end = stack.pop()
        count = end - start
        sl = order[start:end]
        bmin = tmin[sl].min(axis=0)
        bmax = tmax[sl].max(axis=0)
        nodes_bmin[nidx] = bmin.astype(np.float32)
        nodes_bmax[nidx] = bmax.astype(np.float32)
        is_leaf = count == 1 if single_leaf else count <= leaf_size
        if is_leaf:
            nodes_lf[nidx] = start
            nodes_count[nidx] = count
            continue
        mid_rel = None
        if split_method == "sah" and not single_leaf:
            parent_area = float(_surface_area(bmin, bmax))
            axis, split, sorted_order = _sah_split(sl, centroids, tmin, tmax, parent_area)
            if sorted_order is not None and 0 < split < count:
                order[start:end] = sorted_order
                mid_rel = split
        if mid_rel is None:
            reordered, mid_rel = _midpoint_partition(sl, centroids, bmin, bmax)
            order[start:end] = reordered
        mid = start + mid_rel
        left = alloc()
        right = alloc()
        assert right == left + 1
        nodes_lf[nidx] = left
        nodes_count[nidx] = -1
        # pop order: left subtree processed first (allocation order is
        # irrelevant for correctness; children stay adjacent)
        stack.append((right, mid, end))
        stack.append((left, start, mid))

    left_first = np.asarray(nodes_lf, dtype=np.int32)
    count_arr = np.asarray(nodes_count, dtype=np.int32)
    miss = compute_miss_links(left_first, count_arr)
    return BLAS(
        bounds_min=np.stack(nodes_bmin),
        bounds_max=np.stack(nodes_bmax),
        left_first=left_first,
        count=count_arr,
        miss=miss,
        order=order,
    )


def build_blas(
    tri_verts: np.ndarray, leaf_size: int = 4, split_method: str = "sah"
) -> BLAS:
    """Build a BLAS over a (T, 3, 3) triangle soup (BVH::buildBLAS, BVH.cpp:99)."""
    tri_verts = np.asarray(tri_verts, dtype=np.float32).reshape(-1, 3, 3)
    tmin, tmax = _tri_bounds(tri_verts)
    centroids = tri_verts.mean(axis=1)  # (v0+v1+v2)/3, BVH.cpp:41
    return _build(tmin, tmax, centroids, leaf_size, split_method, single_leaf=False)


def build_tlas(inst_bmin: np.ndarray, inst_bmax: np.ndarray) -> TLAS:
    """Build a TLAS over instance world AABBs (BVH::buildTLAS, BVH.cpp:178-240):
    midpoint split on AABB centers, exactly one instance per leaf."""
    inst_bmin = np.asarray(inst_bmin, dtype=np.float32).reshape(-1, 3)
    inst_bmax = np.asarray(inst_bmax, dtype=np.float32).reshape(-1, 3)
    centroids = 0.5 * (inst_bmin + inst_bmax)
    return _build(inst_bmin, inst_bmax, centroids, 1, "midpoint", single_leaf=True)


def compute_miss_links(left_first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Thread the tree with escape links for stackless traversal:
    miss(root) = -1; miss(left) = right sibling; miss(right) = miss(parent)."""
    n = left_first.shape[0]
    miss = np.full(n, -1, dtype=np.int32)
    stack = [(0, -1)]
    while stack:
        node, m = stack.pop()
        miss[node] = m
        if count[node] < 0:  # internal
            left = int(left_first[node])
            right = left + 1
            stack.append((left, right))
            stack.append((right, m))
    return miss


def save_bvh(path: str, bvh: BLAS) -> None:
    """Serialize a built BVH to disk (BVH::saveToFile parity, BVH.cpp:242-253;
    NPZ instead of raw PODs)."""
    np.savez_compressed(
        path if path.endswith(".npz") else path + ".npz",
        bounds_min=bvh.bounds_min,
        bounds_max=bvh.bounds_max,
        left_first=bvh.left_first,
        count=bvh.count,
        miss=bvh.miss,
        order=bvh.order,
    )


def load_bvh(path: str) -> BLAS:
    """Load a serialized BVH (BVH::loadFromFile parity, BVH.cpp:254-265)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        return BLAS(
            bounds_min=z["bounds_min"],
            bounds_max=z["bounds_max"],
            left_first=z["left_first"],
            count=z["count"],
            miss=z["miss"],
            order=z["order"],
        )


def brute_force_closest_hit(origin, direction, tri_verts, t_eps=1e-4, det_eps=1e-4):
    """Numpy Möller–Trumbore over *all* triangles — the oracle for BVH property
    tests (the reference has no tests; SURVEY.md §4 proposes exactly this)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    v = np.asarray(tri_verts, np.float64)
    if v.shape[0] == 0:
        return -1, np.inf
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    h = np.cross(d[None, :], e2)
    a = np.einsum("ij,ij->i", e1, h)
    ok = np.abs(a) >= det_eps
    f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    s = o[None, :] - v[:, 0]
    u = f * np.einsum("ij,ij->i", s, h)
    q = np.cross(s, e1)
    vv = f * np.einsum("j,ij->i", d, q)
    t = f * np.einsum("ij,ij->i", e2, q)
    ok &= (u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1) & (t > t_eps)
    if not ok.any():
        return -1, np.inf
    t = np.where(ok, t, np.inf)
    idx = int(np.argmin(t))
    return idx, float(t[idx])
