"""Deforming-geometry demo: an animated wave surface with two Suzannes,
topology rebuilt ON DEVICE (LBVH) inside the render jit every frame.

Writes wave_0000.png ... wave_NNNN.png. Run on the GPU (default backend) or
the CPU (JAX_PLATFORMS=cpu, keep the resolution small).

Usage: python scripts/deform_demo.py [frames] [width] [height]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from rayzen.cache import setup_compile_cache
from rayzen.camera import Camera
from rayzen.config import RenderConfig
from rayzen.deform import render_deforming
from rayzen.demo import default_obj_dir
from rayzen.image_io import write_png
from rayzen.light import Light, pack_lights
from rayzen.material import Material, pack_materials
from rayzen.mesh import Mesh

FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 8
W = int(sys.argv[2]) if len(sys.argv) > 2 else 640
H = int(sys.argv[3]) if len(sys.argv) > 3 else 360

setup_compile_cache()


def base_geometry():
    """Static (T, 3, 3) triangles + material ids: a g x g water grid plus two
    floating Suzannes that bob with the wave."""
    g = 48
    xs = np.linspace(-3.0, 3.0, g + 1, dtype=np.float32)
    quads = []
    for i in range(g):
        for j in range(g):
            a = (xs[i], 0.0, xs[j])
            b = (xs[i + 1], 0.0, xs[j])
            c = (xs[i + 1], 0.0, xs[j + 1])
            d = (xs[i], 0.0, xs[j + 1])
            quads.append((a, b, c))
            quads.append((a, c, d))
    grid = np.asarray(quads, dtype=np.float32)
    mats = [np.zeros(len(grid), np.int32)]
    parts = [grid]
    obj_dir = default_obj_dir()
    if obj_dir:
        monkey = Mesh.load_from_obj(os.path.join(obj_dir, "monkey.obj"), 0)
        for k, x in enumerate((-1.2, 1.2)):
            v = monkey.vertices * 0.6
            v = v + np.asarray([x, 0.8, 0.0], np.float32)
            parts.append(v)
            mats.append(np.full(len(v), 1 + k, np.int32))
    return np.concatenate(parts), np.concatenate(mats)


verts0, tri_mat = base_geometry()
materials = jnp.asarray(pack_materials([
    Material(albedo=(0.2, 0.45, 0.7), metallic=0.05, roughness=0.15,
             reflectivity=0.6),  # water
    Material(albedo=(0.85, 0.5, 0.2), metallic=0.2, roughness=0.5),
    Material(albedo=(0.9, 0.9, 0.95), metallic=1.0, roughness=0.1,
             reflectivity=1.0),
]))
lights = jnp.asarray(pack_lights([
    Light.point((4.0, 6.0, 4.0), power=220.0),
    Light.directional((0.5, 1.2, 0.3), power=1.5),
]))
cam = Camera(
    position=np.array([0.0, 2.6, 5.0], np.float32),
    target=np.array([0.0, -0.4, -0.9], np.float32),
    aspect_ratio=W / H,
)
cam_p = {k: jnp.asarray(v) for k, v in cam.device_params().items()}
cfg = RenderConfig(width=W, height=H, spp=2, max_bounces=4)

base = jnp.asarray(verts0)
tri_mat_j = jnp.asarray(tri_mat)


def displace(verts, t):
    """The deformation: a traveling wave on every vertex below y < 0.5 and a
    gentle bob above (the Suzannes ride the swell)."""
    x, y, z = verts[..., 0], verts[..., 1], verts[..., 2]
    wave = 0.25 * jnp.sin(1.7 * x + 2.3 * t) * jnp.cos(1.3 * z + 1.1 * t)
    y = jnp.where(y < 0.5, y + wave, y + 0.3 * jnp.sin(2.3 * t))
    return jnp.stack([x, y, z], axis=-1)


@jax.jit
def frame(t):
    return render_deforming(
        displace(base, t), tri_mat_j, materials, lights, cam_p, cfg
    )


t0 = time.perf_counter()
for i in range(FRAMES):
    img = np.asarray(frame(jnp.float32(i * 0.35)))
    write_png(f"wave_{i:04d}.png", img)
    print(f"frame {i}: {time.perf_counter() - t0:.1f}s total", flush=True)
print(f"{FRAMES} frames ({verts0.shape[0]} tris, LBVH rebuilt in-jit each "
      f"frame) in {time.perf_counter() - t0:.1f}s")
