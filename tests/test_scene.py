"""Scene model, OBJ loader, packing, and camera math tests."""

import numpy as np
import pytest

from rayzen import procedural, transforms as tf
from rayzen.camera import Camera, look_at, perspective
from rayzen.config import RenderConfig
from rayzen.demo import build_demo_scene
from rayzen.light import Light
from rayzen.material import Material, pack_materials
from rayzen.mesh import Mesh, parse_obj, save_obj
from rayzen.packing import instance_world_aabbs, pack_scene
from rayzen.scene import GameObject, Scene


class TestObjLoader:
    def test_basic_triangle(self):
        m = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", material_index=4)
        assert m.num_triangles == 1
        assert (m.material_index == 4).all()
        assert np.allclose(m.vertices[0], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])

    def test_fan_triangulation(self):
        # quad -> 2 triangles sharing vertex 0 (Mesh.cpp:40-46)
        m = parse_obj(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
        )
        assert m.num_triangles == 2
        assert np.allclose(m.vertices[0][0], [0, 0, 0])
        assert np.allclose(m.vertices[1][0], [0, 0, 0])

    def test_slash_tokens_keep_position_only(self):
        text = (
            "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
            "vn 0 0 1\nvt 0.5 0.5\n"
            "f 1/1/1 2/1/1 3//1\n"
        )
        m = parse_obj(text)
        assert m.num_triangles == 1

    def test_malformed_lines_skipped(self):
        text = (
            "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
            "v nonsense here\n"        # malformed vertex
            "f 1 2 zzz\n"              # malformed face index
            "f 1 2 99\n"               # out-of-range face index
            "f 1 2 3\n"                # valid
        )
        m = parse_obj(text)
        assert m.num_triangles == 1

    def test_missing_file_returns_empty(self, tmp_path):
        m = Mesh.load_from_obj(str(tmp_path / "car.obj"), 0)
        assert m.num_triangles == 0  # graceful degradation (main.cpp:183-188)

    def test_roundtrip(self, tmp_path):
        orig = procedural.cube(2)
        p = str(tmp_path / "cube.obj")
        save_obj(orig, p)
        back = Mesh.load_from_obj(p, 2)
        assert back.num_triangles == orig.num_triangles
        assert np.allclose(back.vertices, orig.vertices)


class TestProcedural:
    def test_cube(self):
        m = procedural.cube()
        assert m.num_triangles == 12

    def test_icosphere_counts(self):
        assert procedural.icosphere(subdivisions=0).num_triangles == 20
        assert procedural.icosphere(subdivisions=2).num_triangles == 320

    def test_icosphere_on_unit_sphere(self):
        m = procedural.icosphere(subdivisions=2, radius=2.0)
        r = np.linalg.norm(m.vertices.reshape(-1, 3), axis=1)
        assert np.allclose(r, 2.0, atol=1e-5)

    def test_blob_no_cracks(self):
        # identical input positions must deform identically (watertightness)
        m = procedural.blob(subdivisions=2)
        v = m.vertices.reshape(-1, 3)
        uniq = np.unique(np.round(v, 5), axis=0)
        base = procedural.icosphere(subdivisions=2)
        base_uniq = np.unique(np.round(base.vertices.reshape(-1, 3), 5), axis=0)
        assert len(uniq) == len(base_uniq)


class TestTransforms:
    def test_glm_post_multiply_order(self):
        # glm::translate(glm::scale(I, s), t) scales the translation too
        m = tf.translate(tf.scale(tf.identity(), (8.0, 0.5, 8.0)), (0.0, -3.0, 0.0))
        p = tf.transform_point(m, (0.0, 0.0, 0.0))
        assert np.allclose(p, [0.0, -1.5, 0.0])

    def test_inverse(self):
        m = tf.translate(tf.rotate(tf.scale(tf.identity(), 2.0), 0.7, (0, 1, 0)), (1, 2, 3))
        assert np.allclose(m @ tf.inverse(m), np.eye(4), atol=1e-5)


class TestCamera:
    def test_look_at_matches_glm(self):
        # camera at origin looking down -z: view == identity
        v = look_at((0, 0, 0), (0, 0, -1), (0, 1, 0))
        assert np.allclose(v, np.eye(4), atol=1e-6)

    def test_look_at_translation(self):
        v = look_at((0, 0, 3), (0, 0, 2), (0, 1, 0))
        assert np.allclose(v[:3, 3], [0, 0, -3], atol=1e-6)

    def test_perspective_matches_glm(self):
        p = perspective(np.radians(70.0), 4 / 3, 0.1, 100.0)
        t = np.tan(np.radians(35.0))
        assert np.isclose(p[0, 0], 1 / ((4 / 3) * t))
        assert np.isclose(p[1, 1], 1 / t)
        assert np.isclose(p[2, 2], -(100.1) / 99.9)
        assert np.isclose(p[2, 3], -(2 * 100 * 0.1) / 99.9)
        assert p[3, 2] == -1.0

    def test_unproject_center_ray(self):
        cam = Camera(fov=70.0, aspect_ratio=1.0)
        inv_p = cam.inv_projection_matrix
        inv_v = cam.inv_view_matrix
        clip = np.array([0.0, 0.0, -1.0, 1.0], np.float32)
        eye = inv_p @ clip
        eye = np.array([eye[0], eye[1], -1.0, 0.0], np.float32)
        world = (inv_v @ eye)[:3]
        world /= np.linalg.norm(world)
        assert np.allclose(world, [0, 0, -1], atol=1e-6)

    def test_rotate_pitch_clamp(self):
        cam = Camera()
        cam.rotate(0.0, 10000.0)
        assert cam.pitch == 89.0

    def test_move(self):
        cam = Camera()
        z0 = cam.position[2]
        cam.move_forward(1.0)
        assert cam.position[2] < z0


class TestPacking:
    def test_small_scene_layout(self, small_arrays):
        assert small_arrays.num_instances == 4
        total = sum(m.num_triangles for m in small_arrays.instance_meta)
        assert total == int(small_arrays.tri_v0.shape[0])
        assert small_arrays.materials.shape == (5, 8)
        assert small_arrays.lights.shape == (2, 8)

    def test_shared_mesh_dedup(self):
        mesh = procedural.cube(0)
        scene = Scene()
        scene.materials = [Material((1, 1, 1), 0, 1)]
        for i in range(3):
            scene.game_objects.append(
                GameObject(mesh, tf.translate(tf.identity(), (i * 3.0, 0, 0)))
            )
        arrays = pack_scene(scene, RenderConfig())
        assert arrays.tri_v0.shape[0] == 12  # stored once
        assert arrays.num_instances == 3
        assert len({m.mesh_index for m in arrays.instance_meta}) == 1

    def test_demo_scene_parity(self):
        scene = build_demo_scene()
        assert len(scene.materials) == 5
        assert len(scene.lights) == 2
        assert len(scene.game_objects) == 7
        assert scene.game_objects[3].mesh.num_triangles == 0  # missing car.obj
        arrays = pack_scene(scene, RenderConfig())
        assert arrays.num_instances == 7
        assert arrays.instance_meta[3].num_triangles == 0

    def test_instance_world_aabbs(self):
        mesh = procedural.cube(0)  # unit cube [-1, 1]^3
        scene = Scene()
        scene.materials = [Material((1, 1, 1), 0, 1)]
        scene.game_objects.append(
            GameObject(mesh, tf.translate(tf.scale(tf.identity(), 2.0), (1.0, 0, 0)))
        )
        arrays = pack_scene(scene, RenderConfig())
        wmin, wmax = instance_world_aabbs(arrays)
        assert np.allclose(np.asarray(wmin)[0], [0.0, -2.0, -2.0], atol=1e-5)
        assert np.allclose(np.asarray(wmax)[0], [4.0, 2.0, 2.0], atol=1e-5)

    def test_geometry_hash_sensitivity(self):
        s1 = build_demo_scene()
        s2 = build_demo_scene()
        assert s1.geometry_hash() == s2.geometry_hash()
        s2.materials[0] = Material((0.1, 0.1, 0.1), 0, 1)
        assert s1.geometry_hash() != s2.geometry_hash()

    def test_transform_update(self, small_arrays):
        t = np.asarray(small_arrays.transforms).copy()
        t[1] = tf.translate(tf.identity(), (0.0, 5.0, 0.0))
        updated = small_arrays.with_transforms(t)
        assert np.allclose(
            np.asarray(updated.inv_transforms[1])[:3, 3], [0, -5, 0], atol=1e-6
        )


class TestLightsMaterials:
    def test_light_kinds(self):
        p = Light.point((1, 2, 3), power=10.0)
        d = Light.directional((0, 1, 0), power=2.0)
        assert p.is_point_light and not d.is_point_light
        assert np.allclose(p.packed()[:4], [1, 2, 3, 1])
        assert np.allclose(d.packed()[:4], [0, 1, 0, 0])

    def test_material_defaults(self):
        m = Material((1, 0, 0), 0.5, 0.3)
        packed = m.packed()
        assert packed[5] == 0.0 and packed[6] == 0.0 and packed[7] == 1.5

    def test_pack_empty(self):
        assert pack_materials([]).shape == (1, 8)


class TestSceneHash:
    def test_lights_change_hash(self):
        from rayzen.demo import build_small_scene
        from rayzen.light import Light

        s = build_small_scene(8, 8)
        h0 = s.geometry_hash()
        s.lights[0] = Light.point((9.0, 9.0, 9.0), (1.0, 0.5, 0.5), 10.0)
        assert s.geometry_hash() != h0

    def test_transforms_do_not_change_hash(self):
        from rayzen.demo import build_small_scene

        s = build_small_scene(8, 8)
        h0 = s.geometry_hash()
        s.game_objects[0].transform = s.game_objects[0].transform.copy()
        s.game_objects[0].transform[0, 3] += 5.0
        assert s.geometry_hash() == h0


class TestMaterialOverride:
    def test_override_changes_shading_only(self):
        from rayzen.packing import world_geometry

        mesh = procedural.cube(0)
        scene = Scene()
        scene.materials = [
            Material((1.0, 0.0, 0.0), 0, 1),
            Material((0.0, 1.0, 0.0), 0, 1),
        ]
        scene.game_objects.append(GameObject(mesh, tf.identity(), "a"))
        scene.game_objects.append(
            GameObject(
                mesh, tf.translate(tf.identity(), (3.0, 0, 0)), "b",
                material_override=1,
            )
        )
        arrays = pack_scene(scene, RenderConfig())
        assert arrays.tri_v0.shape[0] == 12  # mesh stored once, shared
        ws = world_geometry(arrays)
        wm = np.asarray(ws.tri_mat)
        assert (wm[:12] == 0).all()  # instance a keeps mesh materials
        assert (wm[12:] == 1).all()  # instance b overridden

    def test_override_in_hash(self):
        mesh = procedural.cube(0)
        s = Scene()
        s.materials = [Material((1, 1, 1), 0, 1)]
        s.game_objects.append(GameObject(mesh, tf.identity()))
        h0 = s.geometry_hash()
        s.game_objects[0].material_override = 0
        assert s.geometry_hash() != h0
