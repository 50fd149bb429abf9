"""BVH build + traversal property tests: BVH closest hit must equal brute force
(SURVEY.md §4b). The reference ships no tests; this is the oracle it lacked."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayzen.accel.builder import (
    brute_force_closest_hit,
    build_blas,
    build_tlas,
    compute_miss_links,
)
from rayzen import procedural
from rayzen.config import RenderConfig
from rayzen.mesh import Mesh
from rayzen.packing import pack_scene
from rayzen.scene import GameObject, Scene
from rayzen.ops.traverse import traverse_blas, traverse_scene, brute_force_scene

from conftest import random_rays


def random_soup(n, seed=0, spread=2.0, size=0.5):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-spread, spread, size=(n, 1, 3))
    b = a + rng.uniform(-size, size, size=(n, 2, 3))
    return np.concatenate([a, b], axis=1).astype(np.float32)


class TestBuilder:
    @pytest.mark.parametrize("method", ["sah", "midpoint"])
    @pytest.mark.parametrize("n", [1, 2, 4, 5, 37, 200])
    def test_structure(self, method, n):
        verts = random_soup(n, seed=n)
        blas = build_blas(verts, leaf_size=4, split_method=method)
        # every triangle appears exactly once in leaf order
        assert sorted(blas.order.tolist()) == list(range(n))
        # leaves small enough; internal nodes have adjacent children in range
        leaves = blas.count > 0
        assert (blas.count[leaves] <= 4).all()
        internal = blas.count < 0
        assert (blas.left_first[internal] > 0).all()
        assert (blas.left_first[internal] + 1 < blas.num_nodes).all()
        # leaf ranges tile [0, n)
        starts = blas.left_first[leaves]
        counts = blas.count[leaves]
        covered = np.concatenate(
            [np.arange(s, s + c) for s, c in zip(starts, counts)]
        )
        assert sorted(covered.tolist()) == list(range(n))

    def test_bounds_contain_children(self):
        verts = random_soup(123, seed=3)
        blas = build_blas(verts)
        for i in range(blas.num_nodes):
            if blas.count[i] < 0:
                l = blas.left_first[i]
                for c in (l, l + 1):
                    assert (blas.bounds_min[i] <= blas.bounds_min[c] + 1e-6).all()
                    assert (blas.bounds_max[i] >= blas.bounds_max[c] - 1e-6).all()

    def test_empty_mesh(self):
        blas = build_blas(np.zeros((0, 3, 3), np.float32))
        assert blas.num_nodes == 1
        assert blas.count[0] == 0
        assert (blas.bounds_min[0] > blas.bounds_max[0]).all()  # inverted

    def test_miss_links(self):
        verts = random_soup(50, seed=9)
        blas = build_blas(verts)
        assert blas.miss[0] == -1
        internal = np.where(blas.count < 0)[0]
        for i in internal:
            l = blas.left_first[i]
            assert blas.miss[l] == l + 1  # left's miss is the right sibling
            assert blas.miss[l + 1] == blas.miss[i]  # right's miss is parent's

    def test_tlas_single_instance_leaves(self):
        rng = np.random.RandomState(4)
        bmin = rng.uniform(-5, 5, size=(9, 3)).astype(np.float32)
        bmax = bmin + rng.uniform(0.1, 2, size=(9, 3)).astype(np.float32)
        tlas = build_tlas(bmin, bmax)
        leaves = tlas.count > 0
        assert (tlas.count[leaves] == 1).all()
        assert sorted(tlas.order.tolist()) == list(range(9))


class TestTraversalVsBruteForce:
    @pytest.mark.parametrize("method", ["sah", "midpoint"])
    def test_blas_property(self, method):
        verts = random_soup(300, seed=11)
        blas = build_blas(verts, split_method=method)
        reordered = verts[blas.order]
        mesh = Mesh.from_triangles(reordered)

        scene = Scene()
        scene.game_objects.append(GameObject(Mesh.from_triangles(verts)))
        cfg = RenderConfig(split_method=method)
        arrays = pack_scene(scene, cfg)

        o, d = random_rays(256, seed=12, spread=3.0)
        t, tri = traverse_blas(
            arrays,
            jnp.asarray(o),
            jnp.asarray(d),
            jnp.ones(256, bool),
            arrays.instance_meta[0].node_offset,
            arrays.instance_meta[0].tri_offset,
            leaf_size=cfg.leaf_size,
        )
        t = np.asarray(t)
        tri = np.asarray(tri)
        # brute force over the *packed* (reordered) soup
        packed = np.stack(
            [
                np.asarray(arrays.tri_v0),
                np.asarray(arrays.tri_v0) + np.asarray(arrays.tri_e1),
                np.asarray(arrays.tri_v0) + np.asarray(arrays.tri_e2),
            ],
            axis=1,
        )[:300]
        for i in range(256):
            ref_idx, ref_t = brute_force_closest_hit(o[i], d[i], packed)
            if ref_idx < 0:
                assert tri[i] == -1, f"ray {i}: bvh found spurious hit"
            else:
                assert tri[i] >= 0, f"ray {i}: bvh missed hit t={ref_t}"
                assert np.isclose(t[i], ref_t, rtol=1e-4), f"ray {i}"

    def test_scene_traversal_matches_brute(self, small_arrays):
        o, d = random_rays(512, seed=21, spread=4.0)
        active = jnp.ones(512, bool)
        h_bvh = traverse_scene(small_arrays, jnp.asarray(o), jnp.asarray(d), active)
        h_bf = brute_force_scene(small_arrays, jnp.asarray(o), jnp.asarray(d), active)
        found_bvh = np.asarray(h_bvh.found)
        found_bf = np.asarray(h_bf.found)
        assert (found_bvh == found_bf).all()
        tb, tf = np.asarray(h_bvh.t), np.asarray(h_bf.t)
        m = found_bvh
        assert np.allclose(tb[m], tf[m], rtol=1e-4, atol=1e-5)
        assert (np.asarray(h_bvh.inst)[m] == np.asarray(h_bf.inst)[m]).all()

    def test_empty_mesh_instance_is_inert(self):
        # an empty mesh in the scene (the reference's missing car.obj) must not
        # affect hits or hang traversal
        scene = Scene()
        scene.game_objects.append(GameObject(Mesh()))  # empty
        scene.game_objects.append(GameObject(procedural.cube(0)))
        arrays = pack_scene(scene, RenderConfig())
        o = jnp.asarray([[0.0, 0.0, 5.0]], jnp.float32)
        d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
        h = traverse_scene(arrays, o, d, jnp.ones(1, bool))
        assert bool(h.found[0])
        assert int(h.inst[0]) == 1
        assert np.isclose(float(h.t[0]), 4.0, atol=1e-5)

    def test_mirrored_instance_normal_orientation(self):
        # a mirrored (det<0) instance must produce the same normal as the
        # reference's inverse-transpose rule (glsl:489-490)
        from rayzen.ops.traverse import hit_shading_data
        from rayzen.packing import world_geometry

        mesh = procedural.cube(0)
        for sx in (1.0, -1.0):
            scene = Scene()
            xform = np.diag([sx, 1.0, 1.0, 1.0]).astype(np.float32)
            scene.game_objects.append(GameObject(mesh, xform))
            arrays = pack_scene(scene, RenderConfig())
            ws = world_geometry(arrays)
            o = jnp.asarray([[0.25, 0.25, 5.0]], jnp.float32)
            d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
            hit = traverse_scene(arrays, o, d, jnp.ones(1, bool))
            assert bool(hit.found[0])
            n, _, _ = hit_shading_data(ws, hit)
            n = np.asarray(n)[0]
            # reference rule: n_w = normalize(invT^T @ n_local); the +z cube
            # face has n_local = (0, 0, 1) regardless of mirroring
            inv_t = np.linalg.inv(xform)[:3, :3]
            n_ref = inv_t.T @ np.array([0.0, 0.0, 1.0])
            n_ref /= np.linalg.norm(n_ref)
            assert np.allclose(n, n_ref, atol=1e-5), (sx, n, n_ref)

    def test_inactive_rays_report_no_hit(self, small_arrays):
        o, d = random_rays(64, seed=5)
        active = jnp.zeros(64, bool)
        h = traverse_scene(small_arrays, jnp.asarray(o), jnp.asarray(d), active)
        assert not np.asarray(h.found).any()
