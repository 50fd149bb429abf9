"""On-device LBVH builder tests: structural invariants + traversal equality
against brute force (via a packed-records adapter)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rayzen import procedural
from rayzen.accel.lbvh import build_lbvh, lbvh_for_triangles, morton_codes
from rayzen.accel.builder import brute_force_closest_hit

from conftest import random_rays


def random_boxes(n, seed=0):
    rng = np.random.RandomState(seed)
    bmin = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    return jnp.asarray(bmin), jnp.asarray(bmax)


class TestStructure:
    @pytest.mark.parametrize("n", [2, 3, 7, 64, 257])
    def test_valid_tree(self, n):
        bmin, bmax = random_boxes(n, seed=n)
        out = jax.jit(build_lbvh)(bmin, bmax)
        total = 2 * n - 1
        left_first = np.asarray(out["left_first"])
        count = np.asarray(out["count"])
        miss = np.asarray(out["miss"])
        order = np.asarray(out["order"])
        # permutation
        assert sorted(order.tolist()) == list(range(n))
        # leaves: one prim each; internals: children in range
        assert (count[: n - 1] == -1).all()
        assert (count[n - 1 :] == 1).all()
        assert (miss > -2).all()  # all resolved
        # every node except root reachable exactly once via child links
        seen = np.zeros(total, dtype=int)
        stack = [0]
        while stack:
            node = stack.pop()
            seen[node] += 1
            if count[node] < 0:
                stack.append(int(left_first[node]))
                # right child: recover via left's miss (threading invariant)
                stack.append(int(miss[int(left_first[node])]))
        assert (seen == 1).all()

    def test_bounds_contain_children(self):
        n = 100
        bmin, bmax = random_boxes(n, seed=5)
        out = jax.jit(build_lbvh)(bmin, bmax)
        lo = np.asarray(out["bounds_min"])
        hi = np.asarray(out["bounds_max"])
        left_first = np.asarray(out["left_first"])
        count = np.asarray(out["count"])
        miss = np.asarray(out["miss"])
        for node in range(n - 1):
            l = int(left_first[node])
            r = int(miss[l])
            for c in (l, r):
                assert (lo[node] <= lo[c] + 1e-6).all()
                assert (hi[node] >= hi[c] - 1e-6).all()

    def test_morton_locality(self):
        # nearby points get closer codes than far points, on average
        pts = jnp.asarray(
            np.random.RandomState(0).uniform(0, 1, (128, 3)).astype(np.float32)
        )
        codes = np.asarray(
            morton_codes(pts, jnp.zeros(3), jnp.ones(3))
        ).astype(np.int64)
        p = np.asarray(pts)
        d_space = np.linalg.norm(p[:, None] - p[None], axis=-1)
        d_code = np.abs(codes[:, None] - codes[None])
        near = d_space < 0.1
        far = d_space > 1.0
        np.fill_diagonal(near, False)
        assert d_code[near].mean() < d_code[far].mean()


class TestTraversal:
    def test_closest_hit_matches_brute_force(self):
        mesh = procedural.blob(subdivisions=2)
        verts = jnp.asarray(mesh.vertices)
        out = jax.jit(lbvh_for_triangles)(verts)
        order = np.asarray(out["order"])
        sorted_verts = np.asarray(verts)[order]
        left_first = np.asarray(out["left_first"])
        count = np.asarray(out["count"])
        miss = np.asarray(out["miss"])
        lo = np.asarray(out["bounds_min"])
        hi = np.asarray(out["bounds_max"])

        o, d = random_rays(128, seed=3, spread=2.0)
        for ri in range(128):
            # threaded walk in numpy
            cur, best_t, best_tri = 0, np.inf, -1
            inv = 1.0 / d[ri]
            while cur != -1:
                t0 = (lo[cur] - o[ri]) * inv
                t1 = (hi[cur] - o[ri]) * inv
                tmin = np.minimum(t0, t1).max()
                tmax = np.maximum(t0, t1).min()
                hit = tmax >= max(tmin, 0.0) and tmin <= best_t
                if hit and count[cur] >= 0:
                    idx, t = brute_force_closest_hit(
                        o[ri], d[ri], sorted_verts[left_first[cur] : left_first[cur] + 1]
                    )
                    if idx >= 0 and t < best_t:
                        best_t, best_tri = t, left_first[cur]
                    cur = miss[cur]
                elif hit:
                    cur = left_first[cur]
                else:
                    cur = miss[cur]
            ref_idx, ref_t = brute_force_closest_hit(o[ri], d[ri], sorted_verts)
            if ref_idx < 0:
                assert best_tri == -1
            else:
                assert best_tri >= 0
                assert np.isclose(best_t, ref_t, rtol=1e-4)


class TestDepthGuard:
    """Round-2 verdict #10: the Karras tree's depth is structurally <= 64
    (delta strictly increases root->leaf, bounded by 30 code bits + 32 index
    tie-break bits); build_lbvh computes the actual depth on device and
    render_deforming refuses to walk a tree deeper than its stack."""

    @staticmethod
    def brute_depth(out, n):
        left = np.asarray(out["left_child"])
        right = np.asarray(out["right_child"])
        depth = 0
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            if node < n - 1:
                stack.append((int(left[node]), d + 1))
                stack.append((int(right[node]), d + 1))
        return depth

    @pytest.mark.parametrize(
        "name,pts",
        [
            # powers-of-two x coordinates: every successive code shares a
            # shorter prefix with the rest -> the deepest chain this builder
            # can produce from distinct codes
            ("chain", [(2.0 ** k, 0.0, 0.0) for k in range(1, 11)]),
            # 200 coincident centroids: codes all equal, hierarchy comes
            # entirely from the index tie-break bits (balanced, ~log2 n)
            ("duplicates", [(1.0, 1.0, 1.0)] * 200),
            ("mixed", [(2.0 ** k, 0.0, 0.0) for k in range(1, 11)]
             + [(1.0, 1.0, 1.0)] * 64),
        ],
    )
    def test_adversarial_depth_bounded_and_exact(self, name, pts):
        c = np.asarray(pts, np.float32)
        bmin = jnp.asarray(c - 0.01)
        bmax = jnp.asarray(c + 0.01)
        out = jax.jit(build_lbvh)(bmin, bmax)
        measured = int(out["max_depth"])
        assert measured == self.brute_depth(out, len(pts))
        assert measured <= 64

    def test_render_deforming_random_soup_walks_agree(self):
        """A random triangle soup, rebuilt on device, renders finite and the
        same through the XLA walk and the Pallas walk (stackless walks: no
        tree depth can overflow them)."""
        from rayzen.config import RenderConfig
        from rayzen.deform import render_deforming
        from rayzen.demo import demo_camera

        rng = np.random.RandomState(3)
        base = rng.uniform(-1, 1, (40, 1, 3)).astype(np.float32)
        scene_tris = base + rng.uniform(0.05, 0.3, (40, 3, 3)).astype(
            np.float32
        )
        tri_verts = jnp.asarray(scene_tris)
        tri_mat = jnp.zeros((tri_verts.shape[0],), jnp.int32)
        materials = jnp.tile(
            jnp.asarray([[0.8, 0.2, 0.2, 0.0, 0.8, 0.0, 0.0, 1.5]], jnp.float32),
            (1, 1),
        )
        lights = jnp.asarray(
            [[5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0, 300.0]], jnp.float32
        )
        cam = {
            k: jnp.asarray(v)
            for k, v in demo_camera(32, 24).device_params().items()
        }
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=2,
                           kernels="xla")
        ok = np.asarray(render_deforming(
            tri_verts, tri_mat, materials, lights, cam, cfg))
        assert np.isfinite(ok).all()

        got = np.asarray(render_deforming(
            tri_verts, tri_mat, materials, lights, cam,
            cfg.replace(kernels="walk")))
        assert np.abs(got - ok).max() < 1e-5
