"""Per-ray miss-link walk for the GPU, written in Pallas for the Triton route.

The XLA walk (ops/traverse.py) advances a whole wave in lockstep: its
``while_loop`` runs until the slowest of all rays ends, and every trip gathers
a full node record for every ray, finished or not. Here each program takes one
block of ``BLOCK`` rays and each lane walks its own ray over the same
miss-link records (``WorldArrays.records``) in the same visit order, so the
hits match the XLA walk. The block loops only until its own rays end, and the
ray state stays in registers. Records are gathered per lane, one column at a
time: an internal-node step fetches only its bounds and links (9 floats), and
leaf triangles are loaded only for lanes whose ray entered the leaf.

Closest-hit and shadow queries share one walk body. The shadow variant
multiplies the transmission of every surface it crosses and stops a ray once
its visibility falls to ``min_visibility`` (shadowVisibility, glsl:507-528).

On the CPU the kernel runs in Pallas interpret mode, for tests only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..packing import WorldArrays
from .intersect import DET_EPS, T_EPS, T_FAR
from .traverse import Hit, _resolve_hit

BLOCK = 128  # rays per program: one lane (thread) per ray
NUM_WARPS = BLOCK // 32


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _moller_trumbore(o, d, v0, e1, e2):
    """intersect.moller_trumbore on per-component (BLOCK,) vectors."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    valid = jnp.abs(a) >= DET_EPS
    f = 1.0 / jnp.where(valid, a, 1.0)
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    hit = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_EPS)
    return t, hit


def _slab(o, inv, bmin, bmax):
    """intersect.slab_test on per-component vectors; returns (tmin, hit)."""
    tmin = tmax = None
    for a in range(3):
        t0 = (bmin[a] - o[a]) * inv[a]
        t1 = (bmax[a] - o[a]) * inv[a]
        t0 = jnp.where(t0 != t0, -jnp.inf, t0)  # 0 * inf: no constraint
        t1 = jnp.where(t1 != t1, jnp.inf, t1)
        lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        tmin = lo if tmin is None else jnp.maximum(tmin, lo)
        tmax = hi if tmax is None else jnp.minimum(tmax, hi)
    return tmin, tmax >= jnp.maximum(tmin, 0.0)


def _walk_kernel(rec_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                 bound_ref, cur_ref, *out_refs, leaf_k, shadow,
                 min_visibility, t_eps):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    # huge-but-finite reciprocal, as traverse._safe_inv_dir
    inv = tuple(
        jnp.where(c >= 0.0, 1.0, -1.0) / jnp.maximum(jnp.abs(c), 1e-30)
        for c in d
    )
    bound = bound_ref[...]  # closest hit: T_FAR; shadow: max_dist
    transp_col = 9 + 9 * leaf_k

    def load(row, col, mask=None):
        if mask is None:
            return rec_ref[row, col]
        return plt.load(rec_ref.at[row, col], mask=mask, other=0.0)

    def node_step(cur, t_bound):
        """Box test of each lane's node; returns what the leaf tests and the
        link update need."""
        alive = cur >= 0
        row = jnp.maximum(cur, 0)
        bmin = tuple(load(row, c) for c in range(3))
        bmax = tuple(load(row, c) for c in range(3, 6))
        left_first = load(row, 6).astype(jnp.int32)
        count = load(row, 7).astype(jnp.int32)
        miss = load(row, 8).astype(jnp.int32)
        tmin, box_hit = _slab(o, inv, bmin, bmax)
        box_ok = alive & box_hit & (tmin <= t_bound)  # prune (glsl:430/468)
        is_leaf = count >= 0  # -1 internal; 0 = empty-scene leaf
        nxt = jnp.where(box_ok & ~is_leaf, left_first, miss)
        return alive, row, left_first, count, box_ok & is_leaf, nxt

    def triangle(row, k, lane):
        base = 9 + 9 * k
        v0 = tuple(load(row, base + c, lane) for c in range(3))
        e1 = tuple(load(row, base + 3 + c, lane) for c in range(3))
        e2 = tuple(load(row, base + 6 + c, lane) for c in range(3))
        return _moller_trumbore(o, d, v0, e1, e2)

    def more(state):
        return jnp.max(state[0]) >= 0

    if shadow:
        (vis_ref,) = out_refs

        def body(state):
            cur, vis = state
            alive, row, left_first, count, leaf_ok, nxt = node_step(cur, bound)
            for k in range(leaf_k):
                lane = leaf_ok & (k < count)
                t, h = triangle(row, k, lane)
                blocking = lane & h & (t >= t_eps) & (t < bound)
                transp = load(row, transp_col + k, lane)
                factor = jnp.where(transp > 0.0, transp, 0.0)
                vis = jnp.where(blocking, vis * factor, vis)
            dead = vis <= min_visibility  # early kill (glsl:511)
            cur = jnp.where(alive & ~dead, nxt, jnp.where(dead, -1, cur))
            return cur, vis

        _, vis = jax.lax.while_loop(
            more, body, (cur_ref[...], jnp.ones_like(bound))
        )
        vis_ref[...] = vis
        return

    t_ref, tri_ref = out_refs

    def body(state):
        cur, t_best, tri_best = state
        alive, row, left_first, count, leaf_ok, nxt = node_step(cur, t_best)
        for k in range(leaf_k):
            lane = leaf_ok & (k < count)
            t, h = triangle(row, k, lane)
            better = lane & h & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, left_first + k, tri_best)
        cur = jnp.where(alive, nxt, cur)
        return cur, t_best, tri_best

    cur0 = cur_ref[...]
    _, t_best, tri_best = jax.lax.while_loop(
        more, body, (cur0, bound, jnp.full_like(cur0, -1))
    )
    t_ref[...] = t_best
    tri_ref[...] = tri_best


def _walk(ws: WorldArrays, origin, direction, bound, active, *, shadow,
          interpret, min_visibility=0.05, t_eps=1e-3):
    """Pad the wave to whole blocks (padding rays start finished), split it
    into per-component columns and run one program per block."""
    n = origin.shape[0]
    n_pad = pl.cdiv(n, BLOCK) * BLOCK

    def col(x, fill):
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)

    cur0 = jnp.where(active, 0, -1).astype(jnp.int32)
    cols = [col(origin[:, a], 0.0) for a in range(3)]
    cols += [col(direction[:, a], 1.0) for a in range(3)]
    cols += [col(bound.astype(jnp.float32), 0.0), col(cur0, -1)]

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    if shadow:
        out_shape = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
        out_specs = ray_spec
    else:
        out_shape = (
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        )
        out_specs = (ray_spec, ray_spec)
    kernel = functools.partial(
        _walk_kernel, leaf_k=ws.leaf_k, shadow=shadow,
        min_visibility=min_visibility, t_eps=t_eps,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // BLOCK,),
        in_specs=[pl.BlockSpec(ws.records.shape, lambda i: (0, 0))]
        + [ray_spec] * len(cols),
        out_specs=out_specs,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="shadow_walk" if shadow else "closest_hit_walk",
    )(ws.records, *cols)
    if shadow:
        return out[:n]
    return out[0][:n], out[1][:n]


def closest_hit(ws: WorldArrays, origin, direction, active, *,
                interpret: bool = False) -> Hit:
    """traverse.traverse_world, one lane per ray."""
    t_far = jnp.full((origin.shape[0],), T_FAR, jnp.float32)
    t, tri = _walk(ws, origin, direction, t_far, active, shadow=False,
                   interpret=interpret)
    return _resolve_hit(ws, origin, direction, t, tri)


def shadow_walk(ws: WorldArrays, origin, direction, max_dist, active,
                min_visibility: float = 0.05, t_eps: float = 1e-3, *,
                interpret: bool = False):
    """traverse.shadow_walk, one lane per ray. Returns (visibility, rays)."""
    vis = _walk(ws, origin, direction, max_dist, active, shadow=True,
                interpret=interpret, min_visibility=min_visibility,
                t_eps=t_eps)
    return vis, jnp.sum(active.astype(jnp.int32))
