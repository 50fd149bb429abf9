"""Mouse-picking parity test (reference: brute-force CPU picking in BLAS-debug
mode, main.cpp:502-552)."""

import numpy as np
import jax.numpy as jnp

from rayzen import RenderConfig, pack_scene
from rayzen.accel.builder import build_blas, load_bvh, save_bvh
from rayzen.demo import build_small_scene
from rayzen.picking import pick


def test_pick_center_and_sky(small_scene, small_arrays, small_camera):
    res = (64, 48)
    # camera at (0,0,3) looking down -z: picking near image center should hit
    # one of the two spheres or the glass cube (all near the origin)
    hit = pick(small_arrays, small_camera, (32, 24), res)
    assert hit is not None
    assert hit["instance"] >= 0
    assert hit["t"] > 0
    meta = small_arrays.instance_meta[hit["instance"]]
    assert 0 <= hit["triangle"] < meta.num_triangles
    # top-left corner looks at sky
    miss = pick(small_arrays, small_camera, (1, 46), res)
    assert miss is None


def test_bvh_save_load_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, (50, 1, 3))
    verts = np.concatenate([a, a + rng.uniform(-0.3, 0.3, (50, 2, 3))], axis=1)
    bvh = build_blas(verts.astype(np.float32))
    p = str(tmp_path / "mesh0")
    save_bvh(p, bvh)
    back = load_bvh(p)
    np.testing.assert_array_equal(back.order, bvh.order)
    np.testing.assert_array_equal(back.miss, bvh.miss)
    np.testing.assert_array_equal(back.bounds_min, bvh.bounds_min)
