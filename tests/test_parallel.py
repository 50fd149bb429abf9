"""Multi-chip sharding correctness on the 8-virtual-device CPU mesh: the sharded
render must equal the single-device render exactly (SURVEY.md §4d)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rayzen.config import RenderConfig
from rayzen.integrator import render_radiance
from rayzen.parallel import make_mesh, render_radiance_sharded


@pytest.fixture(scope="module")
def cfg():
    return RenderConfig(width=40, height=24, spp=1, max_bounces=3)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single(small_scene, cfg, small_camera, small_arrays):
    single = np.asarray(render_radiance(small_arrays, small_camera, cfg))
    mesh = make_mesh(8)
    sharded = np.asarray(
        render_radiance_sharded(small_arrays, small_camera, cfg, mesh)
    )
    assert sharded.shape == single.shape
    assert np.abs(sharded - single).max() < 1e-6


def test_sharded_non_divisible_ray_count(small_scene, small_camera, small_arrays):
    # 37x13 = 481 rays, not divisible by 8 -> exercises padding
    cfg = RenderConfig(width=37, height=13, spp=1, max_bounces=2)
    single = np.asarray(render_radiance(small_arrays, small_camera, cfg))
    sharded = np.asarray(
        render_radiance_sharded(small_arrays, small_camera, cfg, make_mesh(8))
    )
    assert np.abs(sharded - single).max() < 1e-6


def test_sharded_under_jit(small_scene, cfg, small_camera, small_arrays):
    # Full-program jit fuses the sin-hash RNG differently than eager op-by-op
    # dispatch, which legitimately perturbs stochastic bounces; compare
    # jit-vs-eager statistically, and jit-vs-jit exactly.
    mesh = make_mesh(4)

    @jax.jit
    def fn(arrays, cam):
        return render_radiance_sharded(arrays, cam, cfg, mesh)

    out = np.asarray(fn(small_arrays, small_camera))
    out2 = np.asarray(fn(small_arrays, small_camera))
    assert (out == out2).all()  # same compilation -> bitwise deterministic
    single = np.asarray(render_radiance(small_arrays, small_camera, cfg))
    d = np.abs(out - single)
    assert d.mean() < 0.01
    assert (d.max(axis=-1) > 0.05).mean() < 0.05


def test_sharded_ray_stats(small_scene, cfg, small_camera, small_arrays):
    # the sharded path must report REAL aggregate ray counts (psum over chips),
    # equal to the single-device count for the identical computation
    from rayzen.integrator import render_radiance_with_stats

    _, rays_single = render_radiance_with_stats(small_arrays, small_camera, cfg)
    img, rays_sharded = render_radiance_sharded(
        small_arrays, small_camera, cfg, make_mesh(8), with_stats=True
    )
    assert int(rays_sharded) > 0
    assert int(rays_sharded) == int(rays_single)


def test_pallas_interpret_inside_shard_map(small_scene, small_camera, small_arrays):
    # the GPU config is the Pallas walk under shard_map; run it (interpret
    # mode on CPU) inside the 8-device mesh and match the XLA path
    cfg_x = RenderConfig(width=32, height=16, spp=1, max_bounces=2, kernels="xla")
    cfg_p = cfg_x.replace(kernels="walk")
    base = np.asarray(
        render_radiance_sharded(small_arrays, small_camera, cfg_x, make_mesh(8))
    )
    kern = np.asarray(
        render_radiance_sharded(small_arrays, small_camera, cfg_p, make_mesh(8))
    )
    assert np.abs(kern - base).max() < 1e-5


def test_walk_ray_stats_inside_shard_map(small_scene, small_camera, small_arrays):
    # the walk's ray counts aggregate over the mesh like the XLA path's, at the
    # full bounce budget with Russian roulette active
    cfg = RenderConfig(width=32, height=16, spp=1, max_bounces=5, kernels="walk")
    img, rays = render_radiance_sharded(
        small_arrays, small_camera, cfg, make_mesh(4), with_stats=True
    )
    base, rays_x = render_radiance_sharded(
        small_arrays, small_camera, cfg.replace(kernels="xla"), make_mesh(4),
        with_stats=True,
    )
    assert np.abs(np.asarray(img) - np.asarray(base)).max() < 1e-5
    assert int(rays) == int(rays_x) > 0
