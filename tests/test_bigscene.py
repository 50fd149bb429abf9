"""Chunked large-scene path: partitioning + chunk-merged rendering parity
(VERDICT r1 #7; reference capability: arbitrary OBJ scenes, Mesh.cpp:6-50)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayzen.bigscene import (
    merge_hits,
    partition_scene,
    render_radiance_chunked,
    split_mesh,
)
from rayzen.config import RenderConfig
from rayzen.demo import build_small_scene
from rayzen.integrator import render_radiance
from rayzen.packing import pack_scene


@pytest.fixture(scope="module")
def scene():
    return build_small_scene(32, 24)


class TestPartition:
    def test_small_scene_passthrough(self, scene):
        assert partition_scene(scene, max_tris=10_000) == [scene]

    def test_partition_preserves_triangles(self, scene):
        total = scene.num_triangles
        chunks = partition_scene(scene, max_tris=max(total // 3, 2))
        assert len(chunks) >= 2
        assert sum(c.num_triangles for c in chunks) == total
        for c in chunks:
            assert c.materials is scene.materials
            assert c.lights is scene.lights

    def test_split_mesh(self, scene):
        mesh = scene.game_objects[0].mesh
        parts = split_mesh(mesh, max_tris=max(mesh.num_triangles // 2, 1))
        assert sum(p.num_triangles for p in parts) == mesh.num_triangles
        assert all(
            p.num_triangles <= max(mesh.num_triangles // 2, 1) for p in parts
        )
        # every triangle survives (as a set of vertex triples)
        orig = {mesh.vertices[i].tobytes() for i in range(mesh.num_triangles)}
        got = {
            p.vertices[i].tobytes()
            for p in parts
            for i in range(p.num_triangles)
        }
        assert got == orig


class TestChunkedRender:
    def test_matches_single_tree(self, scene):
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=2,
                           kernels="xla")
        cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
        single = np.asarray(render_radiance(pack_scene(scene, cfg), cam, cfg))
        chunks = partition_scene(scene, max_tris=max(scene.num_triangles // 3, 2))
        arrays_list = [pack_scene(c, cfg) for c in chunks]
        chunked = np.asarray(
            render_radiance_chunked(arrays_list, cam, cfg)
        )
        assert np.abs(single - chunked).max() < 1e-4

    def test_pallas_chunked(self, scene):
        # the GPU path: the Pallas walk per chunk (interpret on CPU)
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=2,
                           kernels="walk")
        cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
        chunks = partition_scene(scene, max_tris=max(scene.num_triangles // 2, 2))
        arrays_list = [pack_scene(c, cfg) for c in chunks]
        img, rays = render_radiance_chunked(
            arrays_list, cam, cfg, with_stats=True
        )
        ref = np.asarray(
            render_radiance(pack_scene(scene, cfg.replace(kernels="xla")),
                            cam, cfg.replace(kernels="xla"))
        )
        assert int(rays) > 0
        assert np.abs(np.asarray(img) - ref).max() < 1e-4


class TestMergeHits:
    def test_merge_prefers_closer(self, scene):
        from rayzen.ops.traverse import traverse_world
        from rayzen.packing import world_geometry
        from rayzen.ops.camera_rays import generate_rays, pixel_grid

        cfg = RenderConfig(width=16, height=12)
        cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
        frag, uv = pixel_grid(16, 12)
        o, d = generate_rays(uv, jnp.zeros_like(uv), cam["inv_proj"],
                             cam["inv_view"], cam["position"])
        act = jnp.ones(o.shape[0], bool)
        full = traverse_world(world_geometry(pack_scene(scene, cfg)), o, d, act)
        chunks = partition_scene(scene, max_tris=max(scene.num_triangles // 3, 2))
        merged = None
        for c in chunks:
            h = traverse_world(world_geometry(pack_scene(c, cfg)), o, d, act)
            merged = h if merged is None else merge_hits(merged, h)
        np.testing.assert_array_equal(
            np.asarray(full.found), np.asarray(merged.found)
        )
        f = np.asarray(full.found)
        assert np.allclose(np.asarray(full.t)[f], np.asarray(merged.t)[f],
                           rtol=1e-5)
