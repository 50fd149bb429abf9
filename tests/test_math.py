"""Unit tests for intersection/shading primitives (SURVEY.md §4c)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayzen.ops.intersect import (
    T_FAR,
    face_normal,
    moller_trumbore,
    normalize,
    slab_test,
)
from rayzen.ops.shade import (
    fresnel_schlick,
    hemisphere_direction,
    reflect,
    refract_dir,
)


def _mt(o, d, v0, v1, v2):
    o = jnp.asarray([o], jnp.float32)
    d = jnp.asarray([d], jnp.float32)
    v0 = jnp.asarray([v0], jnp.float32)
    e1 = jnp.asarray([v1], jnp.float32) - v0
    e2 = jnp.asarray([v2], jnp.float32) - v0
    t, h = moller_trumbore(o, d, v0, e1, e2)
    return float(t[0]), bool(h[0])


class TestSlab:
    def test_hit_through_box(self):
        o = jnp.asarray([[0.0, 0.0, -5.0]])
        inv = 1.0 / jnp.asarray([[0.0, 0.0, 1.0]])
        tmin, tmax, hit = slab_test(o, inv, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
        assert bool(hit[0])
        assert np.isclose(float(tmin[0]), 4.0)
        assert np.isclose(float(tmax[0]), 6.0)

    def test_miss(self):
        o = jnp.asarray([[0.0, 5.0, -5.0]])
        inv = 1.0 / jnp.asarray([[0.0, 0.0, 1.0]])
        _, _, hit = slab_test(o, inv, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
        assert not bool(hit[0])

    def test_origin_inside(self):
        o = jnp.asarray([[0.0, 0.0, 0.0]])
        inv = 1.0 / jnp.asarray([[1.0, 1e-9, 1e-9]])
        tmin, tmax, hit = slab_test(o, inv, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
        assert bool(hit[0])
        assert float(tmin[0]) <= 0.0

    def test_behind(self):
        o = jnp.asarray([[0.0, 0.0, 5.0]])
        inv = 1.0 / jnp.asarray([[0.0, 0.0, 1.0]])
        _, _, hit = slab_test(o, inv, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
        assert not bool(hit[0])

    # NOTE: an *inverted* AABB (empty-mesh root) acts as an everything-box under
    # min/max slab math — in the reference too. Safety for empty meshes comes
    # from the count-0 leaf (traverse.py) and the zero-triangle instance filter,
    # covered by test_bvh.TestEmptyMesh.


class TestMollerTrumbore:
    TRI = ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0])

    def test_center_hit(self):
        t, h = _mt([0.25, 0.25, 1.0], [0.0, 0.0, -1.0], *self.TRI)
        assert h and np.isclose(t, 1.0)

    def test_outside_miss(self):
        _, h = _mt([0.9, 0.9, 1.0], [0.0, 0.0, -1.0], *self.TRI)
        assert not h

    def test_parallel_miss(self):
        _, h = _mt([0.25, 0.25, 1.0], [1.0, 0.0, 0.0], *self.TRI)
        assert not h

    def test_behind_miss(self):
        _, h = _mt([0.25, 0.25, -1.0], [0.0, 0.0, -1.0], *self.TRI)
        assert not h

    def test_backface_still_hits(self):
        # reference hitTriangle has no backface culling (glsl:396 uses abs)
        t, h = _mt([0.25, 0.25, -1.0], [0.0, 0.0, 1.0], *self.TRI)
        assert h and np.isclose(t, 1.0)

    def test_t_epsilon(self):
        t, h = _mt([0.25, 0.25, 5e-5], [0.0, 0.0, -1.0], *self.TRI)
        assert not h  # t = 5e-5 < 1e-4 epsilon

    def test_face_normal_unflipped(self):
        e1 = jnp.asarray([[1.0, 0.0, 0.0]])
        e2 = jnp.asarray([[0.0, 1.0, 0.0]])
        n = np.asarray(face_normal(e1, e2))
        assert np.allclose(n, [[0.0, 0.0, 1.0]])


class TestShadingMath:
    def test_fresnel_bounds(self):
        f0 = jnp.asarray(0.04)
        assert np.isclose(float(fresnel_schlick(jnp.asarray(1.0), f0)), 0.04)
        assert np.isclose(float(fresnel_schlick(jnp.asarray(0.0), f0)), 1.0)

    def test_reflect(self):
        d = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2)
        n = jnp.asarray([[0.0, 1.0, 0.0]])
        r = np.asarray(reflect(d, n))[0]
        assert np.allclose(r, [1 / np.sqrt(2), 1 / np.sqrt(2), 0.0], atol=1e-6)

    def test_refract_straight_through(self):
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        n = jnp.asarray([[0.0, 0.0, 1.0]])
        eta = jnp.asarray([1.0 / 1.5])
        refr, ok = refract_dir(d, n, eta)
        assert bool(ok[0])
        assert np.allclose(np.asarray(refr)[0], [0.0, 0.0, -1.0], atol=1e-6)

    def test_snell_angle(self):
        # 45 degrees air->glass (ior 1.5): sin(t) = sin(45)/1.5
        inc = np.asarray([1.0, -1.0, 0.0]) / np.sqrt(2)
        d = jnp.asarray([inc.astype(np.float32)])
        n = jnp.asarray([[0.0, 1.0, 0.0]])
        refr, ok = refract_dir(d, n, jnp.asarray([1.0 / 1.5]))
        assert bool(ok[0])
        r = np.asarray(refr)[0]
        sin_t = abs(r[0]) / np.linalg.norm(r)
        assert np.isclose(sin_t, np.sin(np.pi / 4) / 1.5, atol=1e-6)

    def test_total_internal_reflection(self):
        # glass->air at grazing angle: eta = 1.5, beyond critical angle (~41.8°)
        theta = np.radians(60.0)
        inc = np.asarray([np.sin(theta), -np.cos(theta), 0.0])
        d = jnp.asarray([inc.astype(np.float32)])
        n = jnp.asarray([[0.0, 1.0, 0.0]])
        _, ok = refract_dir(d, n, jnp.asarray([1.5]))
        assert not bool(ok[0])

    def test_hemisphere_in_hemisphere_and_unit(self):
        rng = np.random.RandomState(0)
        n = rng.normal(size=(256, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        u = jnp.asarray(rng.uniform(0, 1, 256).astype(np.float32))
        v = jnp.asarray(rng.uniform(0, 1, 256).astype(np.float32))
        d = np.asarray(hemisphere_direction(jnp.asarray(n), u, v))
        assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
        assert (np.einsum("ij,ij->i", d, n) >= -1e-6).all()

    def test_normalize_zero_guard(self):
        v = jnp.zeros((1, 3))
        out = np.asarray(normalize(v, eps=1e-20))
        assert np.isfinite(out).all()
