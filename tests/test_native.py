"""Native (C++) runtime parity: the ctypes-bound builders/parser must produce
exactly the same arrays as the numpy reference implementations."""

import numpy as np
import pytest

from rayzen import procedural
from rayzen.accel import native
from rayzen.accel.builder import build_blas, build_tlas
from rayzen.mesh import save_obj

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime unavailable (no compiler)"
)


def random_soup(n, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-2, 2, size=(n, 1, 3))
    b = a + rng.uniform(-0.5, 0.5, size=(n, 2, 3))
    return np.concatenate([a, b], axis=1).astype(np.float32)


class TestBlasParity:
    @pytest.mark.parametrize("method", ["sah", "midpoint"])
    @pytest.mark.parametrize("n", [0, 1, 4, 5, 64, 500])
    def test_identical_to_python(self, method, n):
        verts = random_soup(n, seed=n + 1)
        py = build_blas(verts, leaf_size=4, split_method=method)
        nat = native.build_blas(verts, leaf_size=4, split_method=method)
        assert py.num_nodes == nat.num_nodes
        np.testing.assert_array_equal(py.left_first, nat.left_first)
        np.testing.assert_array_equal(py.count, nat.count)
        np.testing.assert_array_equal(py.miss, nat.miss)
        np.testing.assert_array_equal(py.order, nat.order)
        np.testing.assert_allclose(py.bounds_min, nat.bounds_min, rtol=0, atol=0)
        np.testing.assert_allclose(py.bounds_max, nat.bounds_max, rtol=0, atol=0)

    def test_real_mesh(self):
        verts = procedural.blob(subdivisions=3).vertices
        py = build_blas(verts)
        nat = native.build_blas(verts)
        np.testing.assert_array_equal(py.order, nat.order)
        np.testing.assert_array_equal(py.miss, nat.miss)


class TestTlasParity:
    def test_identical(self):
        rng = np.random.RandomState(3)
        bmin = rng.uniform(-5, 5, (11, 3)).astype(np.float32)
        bmax = bmin + rng.uniform(0.1, 2, (11, 3)).astype(np.float32)
        py = build_tlas(bmin, bmax)
        nat = native.build_tlas(bmin, bmax)
        np.testing.assert_array_equal(py.order, nat.order)
        np.testing.assert_array_equal(py.left_first, nat.left_first)
        np.testing.assert_array_equal(py.count, nat.count)
        np.testing.assert_array_equal(py.miss, nat.miss)


class TestObjParity:
    def test_roundtrip_matches_python(self, tmp_path):
        mesh = procedural.torus(major_segments=8, minor_segments=6)
        p = str(tmp_path / "t.obj")
        save_obj(mesh, p)
        verts = native.parse_obj_file(p)
        assert verts is not None
        np.testing.assert_allclose(verts, mesh.vertices, rtol=0, atol=0)

    def test_missing_file(self):
        assert native.parse_obj_file("/nonexistent/x.obj") is None

    def test_ngon_and_slash_tokens(self, tmp_path):
        p = tmp_path / "q.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
            "f 1/1/1 2//1 3/1 4\n"
        )
        verts = native.parse_obj_file(str(p))
        assert verts.shape == (2, 3, 3)  # fan-triangulated quad

    def test_out_of_range_indices_skipped(self, tmp_path):
        # faces referencing missing positions are dropped, matching the
        # Python parser's skip-and-log semantics (no UB, no crash)
        p = tmp_path / "bad.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
            "f 1 2 9\n"      # out of range
            "f 0 1 2\n"      # zero (invalid 1-based)
            "f -1 2 3\n"     # negative
            "f 1 2 3\n"      # valid
            "f 1 notanint 3\n"  # malformed token
        )
        verts = native.parse_obj_file(str(p))
        assert verts is not None and verts.shape == (1, 3, 3)
        from rayzen.mesh import parse_obj

        py = parse_obj(p.read_text())
        np.testing.assert_allclose(verts, py.vertices, rtol=0, atol=0)
