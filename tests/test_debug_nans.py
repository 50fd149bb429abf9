"""jax_debug_nans lane (VERDICT r1 #10 / SURVEY §5): representative render
configs must produce no NaNs anywhere in the compiled programs — JAX re-runs
op-by-op and raises on the first NaN-producing primitive.

The traversal paths use huge-but-finite direction reciprocals
(traverse._safe_inv_dir, and the same rule inside ops/walk.py) so axis-parallel
rays never manufacture 0 * inf NaNs."""

import contextlib

import numpy as np
import jax
import pytest

from rayzen.config import RenderConfig
from rayzen.demo import build_small_scene
from rayzen.integrator import render_radiance
from rayzen.packing import pack_scene
from rayzen.preview import render_preview


@contextlib.contextmanager
def debug_nans():
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.fixture(scope="module")
def setup():
    scene = build_small_scene(32, 24)
    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3)
    arrays = pack_scene(scene, cfg)
    cam = {
        k: jax.numpy.asarray(v) for k, v in scene.camera.device_params().items()
    }
    return cfg, arrays, cam


class TestDebugNans:
    def test_xla_path_clean(self, setup):
        cfg, arrays, cam = setup
        with debug_nans():
            img = np.asarray(
                render_radiance(arrays, cam, cfg.replace(kernels="xla"))
            )
        assert np.isfinite(img).all()

    def test_walk_path_clean(self, setup):
        cfg, arrays, cam = setup
        with debug_nans():
            img = np.asarray(
                render_radiance(arrays, cam, cfg.replace(kernels="walk"))
            )
        assert np.isfinite(img).all()

    def test_preview_clean(self, setup):
        cfg, arrays, cam = setup
        with debug_nans():
            img = np.asarray(render_preview(arrays, cam, cfg))
        assert np.isfinite(img).all()

    def test_axis_parallel_rays_clean(self, setup):
        # the historical NaN trap: axis-aligned rays starting exactly on node
        # bound planes (0 * inf in the slab test)
        from rayzen.ops.traverse import shadow_walk, traverse_world
        from rayzen.packing import world_geometry

        cfg, arrays, cam = setup
        ws = world_geometry(arrays)
        bmin = np.asarray(ws.records[0, 0:3])  # root box corner
        o = jax.numpy.asarray(np.tile(bmin, (3, 1)), dtype=np.float32)
        d = jax.numpy.asarray(np.eye(3, dtype=np.float32))  # +x, +y, +z
        act = jax.numpy.ones(3, bool)
        with debug_nans():
            hit = traverse_world(ws, o, d, act)
            vis, _ = shadow_walk(
                ws, o, d, jax.numpy.full((3,), 100.0), act
            )
        assert np.isfinite(np.asarray(hit.t)[np.asarray(hit.found)]).all()
        assert np.isfinite(np.asarray(vis)).all()
