"""End-to-end render tests: BVH-vs-brute golden equality, shading behaviors,
shadow semantics, determinism (SURVEY.md §4a/e)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rayzen import Material, RenderConfig, Scene, GameObject, procedural
from rayzen import transforms as tf
from rayzen.demo import build_small_scene, demo_camera
from rayzen.integrator import render_radiance
from rayzen.light import Light
from rayzen.ops.shade import shadow_visibility, sky_color
from rayzen.packing import world_geometry
from rayzen.packing import pack_scene


def cam_params(scene):
    return {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}


class TestEndToEnd:
    def test_bvh_matches_brute_force_image(self, small_scene, small_arrays, small_camera):
        cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=3)
        img_bvh = np.asarray(render_radiance(small_arrays, small_camera, cfg, tracer="bvh"))
        img_bf = np.asarray(render_radiance(small_arrays, small_camera, cfg, tracer="brute"))
        assert np.abs(img_bvh - img_bf).max() < 1e-5

    def test_deterministic(self, small_arrays, small_camera):
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3)
        a = np.asarray(render_radiance(small_arrays, small_camera, cfg))
        b = np.asarray(render_radiance(small_arrays, small_camera, cfg))
        assert (a == b).all()

    def test_empty_scene_is_sky(self):
        scene = Scene()
        scene.camera = demo_camera(32, 24)
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=2)
        arrays = pack_scene(scene, cfg)
        img = np.asarray(render_radiance(arrays, cam_params(scene), cfg))
        # pure sky gradient: blue channel dominant everywhere, rows constant
        assert (img[..., 2] >= img[..., 0]).all()
        assert np.allclose(img[5, 0], img[5, -1], atol=2e-3)

    def test_output_range_and_shape(self, small_arrays, small_camera):
        cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=3)
        img = np.asarray(render_radiance(small_arrays, small_camera, cfg))
        assert img.shape == (48, 64, 3)
        assert img.min() >= 0.0 and img.max() <= 1.0
        assert np.isfinite(img).all()

    def test_hash_rng_mode(self, small_arrays, small_camera):
        cfg = RenderConfig(width=32, height=24, spp=2, max_bounces=3, rng="threefry")
        img = np.asarray(render_radiance(small_arrays, small_camera, cfg))
        assert np.isfinite(img).all() and img.max() <= 1.0

    def test_spp_averaging(self, small_arrays, small_camera):
        cfg1 = RenderConfig(width=32, height=24, spp=1, max_bounces=2)
        cfg4 = cfg1.replace(spp=4)
        i1 = np.asarray(render_radiance(small_arrays, small_camera, cfg1))
        i4 = np.asarray(render_radiance(small_arrays, small_camera, cfg4))
        # means should be close (same estimator), not identical
        assert abs(i1.mean() - i4.mean()) < 0.05

    def test_zero_lights_ambient_only(self):
        # no lights: direct lighting reduces to the ambient term; image is
        # finite and darker than the lit version
        scene = build_small_scene(32, 24)
        lit_arrays = pack_scene(scene, RenderConfig())
        cam = cam_params(scene)
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3)
        lit = np.asarray(render_radiance(lit_arrays, cam, cfg))
        scene.lights = []
        dark_arrays = pack_scene(scene, cfg)
        dark = np.asarray(render_radiance(dark_arrays, cam, cfg))
        assert np.isfinite(dark).all()
        assert dark.mean() < lit.mean()

    def test_bounce_budget_changes_image(self, small_arrays, small_camera):
        cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=5)
        full = np.asarray(render_radiance(small_arrays, small_camera, cfg))
        one = np.asarray(render_radiance(small_arrays, small_camera, cfg, max_bounces=1))
        assert np.abs(full - one).max() > 1e-3


def _single_object_scene(material, mesh=None, light=None):
    scene = Scene()
    scene.camera = demo_camera(48, 48)
    scene.camera.aspect_ratio = 1.0
    scene.materials = [material]
    scene.lights = [light or Light.point((5.0, 5.0, 5.0), power=300.0)]
    scene.game_objects.append(
        GameObject(mesh or procedural.icosphere(0, subdivisions=2), tf.translate(tf.identity(), (0, 0, 0)))
    )
    return scene


class TestShadingBehavior:
    CFG = RenderConfig(width=48, height=48, spp=1, max_bounces=3)

    def _render(self, scene):
        arrays = pack_scene(scene, self.CFG)
        return np.asarray(render_radiance(arrays, cam_params(scene), self.CFG))

    def test_albedo_tints_diffuse(self):
        red = self._render(_single_object_scene(Material((0.8, 0.1, 0.1), 0.0, 1.0)))
        green = self._render(_single_object_scene(Material((0.1, 0.8, 0.1), 0.0, 1.0)))
        # center pixel looks at the sphere
        c_red = red[24, 24]
        c_green = green[24, 24]
        assert c_red[0] > c_red[1]
        assert c_green[1] > c_green[0]

    def test_mirror_reflects_sky(self):
        mirror = Material((1.0, 1.0, 1.0), 1.0, 0.05, 1.0)
        img = self._render(_single_object_scene(mirror))
        c = img[24, 24]
        assert c[2] > 0.15  # sky bounce is blueish

    def test_shadowing_darkens(self):
        # floor + blocker between light and floor vs floor alone
        light = Light.point((0.0, 5.0, 0.0), power=100.0)
        base = Scene()
        base.camera = demo_camera(48, 48)
        base.camera.position = np.array([0.0, 2.0, 6.0], np.float32)
        base.camera.target = np.array([0.0, -0.5, -1.0], np.float32)
        base.materials = [Material((0.8, 0.8, 0.8), 0.0, 1.0)]
        base.lights = [light]
        base.game_objects.append(
            GameObject(procedural.cube(0), tf.translate(tf.scale(tf.identity(), (6.0, 0.2, 6.0)), (0, -8.0, 0)))
        )
        img_open = self._render(base)

        blocker = procedural.cube(0)
        base.game_objects.append(
            GameObject(blocker, tf.translate(tf.scale(tf.identity(), (1.5, 0.1, 1.5)), (0, 25.0, 0)))
        )
        img_blocked = self._render(base)
        assert img_blocked.mean() < img_open.mean() - 0.01

    def test_transparent_shadow_passes_light(self):
        # glass blocker lets most light through vs opaque blocker
        def scene_with_blocker(mat):
            s = Scene()
            s.camera = demo_camera(48, 48)
            s.camera.position = np.array([0.0, 2.0, 6.0], np.float32)
            s.camera.target = np.array([0.0, -0.5, -1.0], np.float32)
            s.materials = [Material((0.8, 0.8, 0.8), 0.0, 1.0), mat]
            s.lights = [Light.point((0.0, 8.0, 0.0), power=200.0)]
            s.game_objects.append(
                GameObject(procedural.cube(0), tf.translate(tf.scale(tf.identity(), (6.0, 0.2, 6.0)), (0, -8.0, 0)))
            )
            s.game_objects.append(
                GameObject(procedural.cube(1), tf.translate(tf.scale(tf.identity(), (1.5, 0.1, 1.5)), (0, 25.0, 0)))
            )
            return s

        glass = Material((0.9, 0.9, 1.0), 0.0, 0.02, 0.05, 0.94, 1.5)
        opaque = Material((0.9, 0.9, 1.0), 0.0, 0.5)
        img_glass = self._render(scene_with_blocker(glass))
        img_opaque = self._render(scene_with_blocker(opaque))
        assert img_glass.mean() > img_opaque.mean() + 0.005


class TestShadowQuery:
    def test_visibility_through_stacked_glass(self):
        # two glass slabs: visibility = 0.94^2; three opaque: 0
        s = Scene()
        s.camera = demo_camera(8, 8)
        glass = Material((1, 1, 1), 0.0, 0.0, 0.0, 0.94, 1.5)
        s.materials = [glass]
        s.lights = [Light.point((0, 10, 0), power=10.0)]
        for y in (2.0, 4.0):
            s.game_objects.append(
                GameObject(
                    procedural.cube(0),
                    tf.translate(tf.scale(tf.identity(), (5.0, 0.1, 5.0)), (0, y / 0.1, 0)),
                )
            )
        cfg = RenderConfig()
        ws = world_geometry(pack_scene(s, cfg))
        # offset from the cube-face diagonal: a ray exactly on the shared edge
        # of two coplanar triangles would count the face twice (see
        # traverse.shadow_walk notes)
        origin = jnp.asarray([[0.3, 0.0, 0.2]], jnp.float32)
        direction = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
        res = shadow_visibility(
            ws, origin, direction, jnp.asarray([10.0]), jnp.ones(1, bool), cfg
        )
        assert bool(res.visible[0])
        # passes through 2 slabs x 2 faces each = 0.94^4
        assert np.isclose(float(res.visibility[0]), 0.94 ** 4, atol=1e-3)

    def test_opaque_blocks(self):
        s = Scene()
        s.camera = demo_camera(8, 8)
        s.materials = [Material((1, 1, 1), 0.0, 1.0)]
        s.lights = [Light.point((0, 10, 0), power=10.0)]
        s.game_objects.append(
            GameObject(
                procedural.cube(0),
                tf.translate(tf.scale(tf.identity(), (5.0, 0.1, 5.0)), (0, 20.0, 0)),
            )
        )
        cfg = RenderConfig()
        ws = world_geometry(pack_scene(s, cfg))
        res = shadow_visibility(
            ws,
            jnp.asarray([[0.0, 0.0, 0.0]]),
            jnp.asarray([[0.0, 1.0, 0.0]]),
            jnp.asarray([10.0]),
            jnp.ones(1, bool),
            cfg,
        )
        assert not bool(res.visible[0])
        assert float(res.visibility[0]) == 0.0

    def test_reaching_light_before_geometry(self):
        s = Scene()
        s.camera = demo_camera(8, 8)
        s.materials = [Material((1, 1, 1), 0.0, 1.0)]
        s.lights = [Light.point((0, 1, 0), power=10.0)]
        s.game_objects.append(
            GameObject(
                procedural.cube(0),
                tf.translate(tf.scale(tf.identity(), (5.0, 0.1, 5.0)), (0, 50.0, 0)),
            )
        )
        cfg = RenderConfig()
        ws = world_geometry(pack_scene(s, cfg))
        res = shadow_visibility(
            ws,
            jnp.asarray([[0.0, 0.0, 0.0]]),
            jnp.asarray([[0.0, 1.0, 0.0]]),
            jnp.asarray([1.0]),  # light is below the slab at y=5
            jnp.ones(1, bool),
            cfg,
        )
        assert bool(res.visible[0])
        assert float(res.visibility[0]) == 1.0


class TestSky:
    def test_gradient(self):
        cfg = RenderConfig()
        up = sky_color(jnp.asarray([[0.0, 1.0, 0.0]]), cfg)
        down = sky_color(jnp.asarray([[0.0, -1.0, 0.0]]), cfg)
        assert np.allclose(np.asarray(up)[0], cfg.sky_zenith, atol=1e-6)
        assert np.allclose(np.asarray(down)[0], cfg.sky_horizon, atol=1e-6)


class TestLeafSize:
    @pytest.mark.parametrize("kernels", ["xla", "walk"])
    def test_leaf_size_8_matches_brute(self, small_scene, kernels):
        # leaf_size is a documented knob; inlined leaf tables must carry ALL
        # leaf triangles, not just the first 4 (regression: advisor r1)
        cfg = RenderConfig(
            width=48, height=32, spp=1, max_bounces=3, leaf_size=8,
            kernels=kernels,
        )
        arrays = pack_scene(small_scene, cfg)
        cam = cam_params(small_scene)
        img = np.asarray(render_radiance(arrays, cam, cfg))
        ref = np.asarray(render_radiance(arrays, cam, cfg, tracer="brute"))
        assert np.abs(img - ref).max() < 1e-5
