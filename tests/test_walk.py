"""The GPU walk kernel (ops/walk.py) against the XLA walk (ops/traverse.py),
in Pallas interpret mode on the CPU, and the platform's choice of walk."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayzen import transforms as tf
from rayzen.config import RenderConfig
from rayzen.demo import build_small_scene
from rayzen.integrator import render_radiance, select_kernels
from rayzen.ops import traverse, walk
from rayzen.ops.camera_rays import generate_rays, pixel_grid
from rayzen.packing import pack_scene, world_geometry
from rayzen.scene import Scene

SCENES = ("instanced", "mirrored", "transparent", "empty")


def _scene(kind):
    scene = build_small_scene(32, 24)
    if kind == "mirrored":  # det < 0 instance transforms
        for go in scene.game_objects[1:]:
            go.transform = tf.scale(np.asarray(go.transform), (-1.0, 1.0, 1.0))
    elif kind == "transparent":  # shadows must multiply transmission
        for m in scene.materials:
            m.transparency = 0.5
    elif kind == "empty":
        empty = Scene()
        empty.camera, empty.lights = scene.camera, scene.lights
        empty.materials = scene.materials
        scene = empty
    return scene


@functools.lru_cache(maxsize=None)
def _world(kind, leaf_size):
    scene = _scene(kind)
    arrays = pack_scene(scene, RenderConfig(width=32, height=24, leaf_size=leaf_size))
    cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
    return world_geometry(arrays), cam


def _rays(cam, width=20, height=15):
    _, uv = pixel_grid(width, height)
    return generate_rays(uv, jnp.zeros_like(uv), cam["inv_proj"],
                         cam["inv_view"], cam["position"])


def _assert_same_hits(ref, got):
    np.testing.assert_array_equal(np.asarray(ref.tri), np.asarray(got.tri))
    np.testing.assert_array_equal(np.asarray(ref.found), np.asarray(got.found))
    np.testing.assert_array_equal(np.asarray(ref.inst), np.asarray(got.inst))
    np.testing.assert_array_equal(np.asarray(ref.mat), np.asarray(got.mat))
    m = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.normal)[m],
                               np.asarray(ref.normal)[m], atol=1e-6)


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("kind", SCENES)
def test_closest_hit_matches_xla(kind, leaf_size):
    ws, cam = _world(kind, leaf_size)
    o, d = _rays(cam)
    act = jnp.ones((o.shape[0],), bool)
    ref = traverse.traverse_world(ws, o, d, act)
    got = walk.closest_hit(ws, o, d, act, interpret=True)
    _assert_same_hits(ref, got)
    if kind == "empty":
        assert not np.asarray(got.found).any()
    else:
        assert np.asarray(got.found).sum() > 0


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("kind", SCENES)
def test_shadow_matches_xla(kind, leaf_size):
    ws, cam = _world(kind, leaf_size)
    o, d = _rays(cam)
    act = jnp.ones((o.shape[0],), bool)
    hit = traverse.traverse_world(ws, o, d, act)
    ldir = jnp.asarray([0.3, 0.9, 0.1], jnp.float32)
    ldir = jnp.broadcast_to(ldir / jnp.linalg.norm(ldir), o.shape)
    origin = hit.point + ldir * 1e-3
    dist = jnp.full((o.shape[0],), 50.0, jnp.float32)
    v_ref, n_ref = traverse.shadow_walk(ws, origin, ldir, dist, hit.found)
    v_got, n_got = walk.shadow_walk(ws, origin, ldir, dist, hit.found,
                                    interpret=True)
    np.testing.assert_allclose(np.asarray(v_got), np.asarray(v_ref), atol=1e-6)
    assert int(n_got) == int(n_ref)
    if kind == "transparent":  # partial transmission occurs
        v = np.asarray(v_got)
        assert ((v > 0.0) & (v < 1.0)).any()


@pytest.mark.parametrize("n_rays", [1, walk.BLOCK - 1, walk.BLOCK + 1, 300])
def test_ray_counts_off_the_block(n_rays):
    """Waves that are not a whole number of blocks are padded with finished
    rays; results come back at the wave's own length."""
    ws, cam = _world("instanced", 8)
    o, d = _rays(cam, 20, 15)
    o, d = o[:n_rays], d[:n_rays]
    act = jnp.ones((n_rays,), bool)
    got = walk.closest_hit(ws, o, d, act, interpret=True)
    assert got.t.shape == (n_rays,)
    _assert_same_hits(traverse.traverse_world(ws, o, d, act), got)
    vis, n = walk.shadow_walk(ws, o, d, jnp.full((n_rays,), 5.0), act,
                              interpret=True)
    assert vis.shape == (n_rays,) and int(n) == n_rays


def test_inactive_lanes():
    ws, cam = _world("instanced", 8)
    o, d = _rays(cam)
    act = jnp.arange(o.shape[0]) % 3 != 1
    ref = traverse.traverse_world(ws, o, d, act)
    got = walk.closest_hit(ws, o, d, act, interpret=True)
    _assert_same_hits(ref, got)
    off = ~np.asarray(act)
    assert (np.asarray(got.tri)[off] == -1).all()
    vis, n = walk.shadow_walk(ws, o, d, jnp.full((o.shape[0],), 50.0), act,
                              interpret=True)
    assert (np.asarray(vis)[off] == 1.0).all()
    assert int(n) == int(np.asarray(act).sum())


@pytest.mark.parametrize("bounces", [2, 5])
def test_full_render_matches_xla(small_arrays, small_camera, bounces):
    cfg = RenderConfig(width=24, height=16, spp=1, max_bounces=bounces)
    xla = np.asarray(render_radiance(small_arrays, small_camera,
                                     cfg.replace(kernels="xla")))
    got = np.asarray(render_radiance(small_arrays, small_camera,
                                     cfg.replace(kernels="walk")))
    assert np.abs(xla - got).max() < 1e-5


AXES = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]


@pytest.mark.parametrize("axis", AXES)
def test_axis_parallel_rays(axis):
    """Rays along an axis hit the huge-but-finite reciprocal path of the slab
    test; origins on a grid through the scene also start inside boxes."""
    ws, _ = _world("instanced", 4)
    g = np.linspace(-2.5, 2.5, 12, dtype=np.float32)
    a = int(np.argmax(np.abs(axis)))
    u, v = [i for i in range(3) if i != a]
    pts = np.zeros((g.size * g.size, 3), np.float32)
    pts[:, u] = np.repeat(g, g.size)
    pts[:, v] = np.tile(g, g.size)
    pts[:, a] = -6.0 * axis[a]
    o = jnp.asarray(pts)
    d = jnp.broadcast_to(jnp.asarray(axis, jnp.float32), o.shape)
    act = jnp.ones((o.shape[0],), bool)
    ref = traverse.traverse_world(ws, o, d, act)
    got = walk.closest_hit(ws, o, d, act, interpret=True)
    _assert_same_hits(ref, got)
    assert np.asarray(got.found).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incoherent_rays_match_brute_force(seed):
    """Random origins and directions (no screen coherence inside a block)
    against the BVH-free oracle."""
    from conftest import random_rays

    ws, _ = _world("instanced", 8)
    o, d = random_rays(200, seed=seed, spread=3.0)
    o, d = jnp.asarray(o), jnp.asarray(d)
    act = jnp.ones((200,), bool)
    got = walk.closest_hit(ws, o, d, act, interpret=True)
    ref = traverse.brute_force_world(ws, o, d, act)
    np.testing.assert_array_equal(np.asarray(got.found), np.asarray(ref.found))
    m = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)


@pytest.mark.parametrize("min_visibility", [0.0, 0.05, 0.3])
def test_shadow_visibility_floor(min_visibility):
    """The early kill at min_visibility ends a ray's walk with the same
    visibility the XLA walk reports, whatever the floor."""
    ws, cam = _world("transparent", 4)
    o, d = _rays(cam)
    act = jnp.ones((o.shape[0],), bool)
    hit = traverse.traverse_world(ws, o, d, act)
    ldir = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), o.shape)
    args = (ws, hit.point + ldir * 1e-3, ldir,
            jnp.full((o.shape[0],), 50.0, jnp.float32), hit.found)
    v_ref, _ = traverse.shadow_walk(*args, min_visibility=min_visibility)
    v_got, _ = walk.shadow_walk(*args, min_visibility=min_visibility,
                                interpret=True)
    np.testing.assert_allclose(np.asarray(v_got), np.asarray(v_ref), atol=1e-6)


class TestSelectKernels:
    def _patch_backend(self, monkeypatch, name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    def test_gpu_auto_is_the_compiled_walk(self, monkeypatch):
        self._patch_backend(monkeypatch, "gpu")
        hit_fn, shadow_fn = select_kernels(RenderConfig())
        assert hit_fn.func is walk.closest_hit
        assert shadow_fn.func is walk.shadow_walk
        assert hit_fn.keywords == {"interpret": False}
        assert shadow_fn.keywords == {"interpret": False}

    def test_gpu_xla_on_request(self, monkeypatch):
        self._patch_backend(monkeypatch, "gpu")
        assert select_kernels(RenderConfig(kernels="xla")) == (
            traverse.traverse_world, traverse.shadow_walk)

    def test_cpu_auto_is_xla(self, monkeypatch):
        self._patch_backend(monkeypatch, "cpu")
        assert select_kernels(RenderConfig()) == (
            traverse.traverse_world, traverse.shadow_walk)

    def test_cpu_walk_by_name_interprets(self, monkeypatch):
        self._patch_backend(monkeypatch, "cpu")
        hit_fn, shadow_fn = select_kernels(RenderConfig(kernels="walk"))
        assert hit_fn.keywords == shadow_fn.keywords == {"interpret": True}

    @pytest.mark.parametrize("kernels", ["auto", "walk", "xla"])
    def test_other_platforms_refused(self, monkeypatch, kernels):
        self._patch_backend(monkeypatch, "rocm")
        with pytest.raises(RuntimeError):
            select_kernels(RenderConfig(kernels=kernels))

    def test_unknown_kernels_value(self):
        with pytest.raises(ValueError):
            select_kernels(RenderConfig(kernels="pallas"))

    def test_brute_tracer_ignores_platform(self, monkeypatch):
        self._patch_backend(monkeypatch, "rocm")
        assert select_kernels(RenderConfig(), tracer="brute") == (
            traverse.brute_force_world, traverse.shadow_brute)


@pytest.mark.gpu
def test_compiled_walk_matches_xla(gpu):
    """The walk as the GPU compiles it, against the XLA walk."""
    ws, cam = _world("instanced", 8)
    o, d = _rays(cam, 64, 48)
    act = jnp.ones((o.shape[0],), bool)
    ref = jax.jit(traverse.traverse_world)(ws, o, d, act)
    got = jax.jit(walk.closest_hit)(ws, o, d, act)
    _assert_same_hits(ref, got)
    hit = ref
    ldir = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), o.shape)
    dist = jnp.full((o.shape[0],), 50.0, jnp.float32)
    args = (ws, hit.point + ldir * 1e-3, ldir, dist, hit.found)
    v_ref, _ = jax.jit(traverse.shadow_walk)(*args)
    v_got, _ = jax.jit(walk.shadow_walk)(*args)
    np.testing.assert_allclose(np.asarray(v_got), np.asarray(v_ref), atol=1e-5)


def test_records_layout_is_what_the_walk_reads():
    """The walk reads records by column: bounds 0:6, links 6:9, triangles
    9:9+9K, transparency 9+9K:9+10K."""
    ws, _ = _world("transparent", 4)
    k = ws.leaf_k
    assert ws.records.shape[1] >= 9 + 11 * k
    rec = np.asarray(ws.records)
    leaf = rec[:, 7] >= 1  # count column
    first = rec[leaf, 6].astype(int)
    np.testing.assert_allclose(rec[leaf, 9:12], np.asarray(ws.tri_v0)[first])
    transp = np.asarray(ws.materials)[np.asarray(ws.tri_mat)[first], 6]
    np.testing.assert_allclose(rec[leaf, 9 + 9 * k], transp)
