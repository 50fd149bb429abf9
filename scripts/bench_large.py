"""Large-scene run: a ~500k-triangle Suzanne field (or two dense Suzannes)
through the default path, as one tree or as chunked trees.

Usage: python scripts/bench_large.py [instances] [single|chunked] [chunk_tris] [+mesh]

The image is gated against the XLA walk's at reduced size before any time is
printed; the last line of standard output is the Mrays/s."""

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from rayzen.bigscene import partition_scene, render_radiance_chunked
from rayzen.cache import setup_compile_cache
from rayzen.camera import Camera
from rayzen.config import RenderConfig
from rayzen.demo import ASSET_DIR
from rayzen.light import Light
from rayzen.material import Material
from rayzen.mesh import Mesh
from rayzen.packing import pack_scene
from rayzen.scene import GameObject, Scene
from rayzen.transforms import rotation, translation

setup_compile_cache()

N_INSTANCES = int(sys.argv[1]) if len(sys.argv) > 1 else 520  # x968 tris
# RAYZEN_LARGE_* envs shrink the run for CPU smoke tests (defaults = the
# on-chip measurement shape; tests/test_campaign_smoke.py pins the smoke).
W = int(os.environ.get("RAYZEN_LARGE_W", "1920"))
H = int(os.environ.get("RAYZEN_LARGE_H", "1080"))
SPP = int(os.environ.get("RAYZEN_LARGE_SPP", "4"))

mode_argv = sys.argv[2] if len(sys.argv) > 2 else "single"
variant_argv = sys.argv[4] if len(sys.argv) > 4 else ""

monkey = Mesh.load_from_obj(os.path.join(ASSET_DIR, "monkey.obj"), 0)
if "+mesh" in variant_argv:
    # Dense-SURFACE large scene: two midpoint-subdivided Suzannes (~248k
    # tris each) instead of a 520-instance field. Same triangle budget,
    # different coherence class: screen tiles see one smooth surface region,
    # not dozens of far-apart instances — the shape real high-poly assets
    # have. The field stays as the adversarial many-instance case.
    from rayzen.procedural import subdivide

    levels = max(1, round(math.log(max(N_INSTANCES, 16) / 968, 4)))
    dense = subdivide(monkey, levels, displace=0.01)
    objs = [
        GameObject(
            mesh=dense,
            transform=translation((-1.25, 0.0, 0.0)),
            material_override=0,
        ),
        GameObject(
            mesh=dense,
            transform=translation((1.25, 0.0, 0.0))
            @ rotation(math.radians(25.0), (0.0, 1.0, 0.0)),
            material_override=2,
        ),
    ]
    cam_pos = np.array([0.0, 0.4, 3.4], np.float32)
    cam_tgt = np.array([0.0, -0.08, -0.99], np.float32)
else:
    side = int(math.ceil(math.sqrt(N_INSTANCES)))
    objs = []
    for i in range(N_INSTANCES):
        gx, gz = i % side, i // side
        objs.append(
            GameObject(
                mesh=monkey,
                transform=translation(
                    (2.2 * (gx - side / 2), 0.0, -2.2 * gz)
                ) @ rotation(math.radians((i * 37.0) % 360.0), (0.0, 1.0, 0.0)),
                material_override=i % 3,
            )
        )
    cam_pos = np.array([0.0, 6.0, 8.0], np.float32)
    cam_tgt = np.array([0.0, -0.45, -0.89], np.float32)
scene = Scene(
    camera=Camera(
        position=cam_pos,
        target=cam_tgt,
        aspect_ratio=W / H,
    ),
    materials=[
        Material(albedo=(0.8, 0.2, 0.2), metallic=0.1, roughness=0.4),
        Material(albedo=(0.2, 0.8, 0.3), metallic=0.9, roughness=0.25),
        Material(albedo=(0.9, 0.9, 0.9), metallic=1.0, roughness=0.05,
                 reflectivity=1.0),
    ],
    lights=[
        Light(position_or_direction=(5.0, 10.0, 5.0, 1.0),
              color=(1.0, 1.0, 1.0), power=300.0),
        Light(position_or_direction=(0.8, 1.4, 0.3, 0.0),
              color=(1.0, 1.0, 1.0), power=2.0),
    ],
    game_objects=objs,
)
total_tris = scene.num_triangles
kind = "dense mesh x2" if "+mesh" in variant_argv else f"{N_INSTANCES} Suzannes"
print(f"# {kind}: {total_tris} world triangles", file=sys.stderr)

cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
mode = mode_argv  # single | chunked
CHUNK_TRIS = int(sys.argv[3]) if len(sys.argv) > 3 and sys.argv[3] else 250_000
cfg = RenderConfig(width=W, height=H, spp=SPP, max_bounces=5)

if mode == "chunked":
    chunks = partition_scene(scene, CHUNK_TRIS)
    arrays_in = tuple(pack_scene(c, cfg) for c in chunks)
    fn = jax.jit(
        lambda al, c: render_radiance_chunked(al, c, cfg, with_stats=True)
    )
    detail = f"{len(chunks)} chunks of <= {CHUNK_TRIS} triangles"
else:
    from rayzen.integrator import render_radiance_with_stats

    arrays_in = pack_scene(scene, cfg)
    fn = jax.jit(lambda a, c: render_radiance_with_stats(a, c, cfg))
    detail = f"one tree: {arrays_in.uni_meta.shape[0]} nodes"

# ---- correctness gate: the timed path must reproduce the XLA walk's image
# at reduced size before any number is printed.
from rayzen.image_io import ssim
from rayzen.integrator import render_radiance

GW = int(os.environ.get("RAYZEN_LARGE_GATE_W", "320"))
GH = int(os.environ.get("RAYZEN_LARGE_GATE_H", "180"))
gate_scene = Scene(camera=Camera(
    position=scene.camera.position, target=scene.camera.target,
    aspect_ratio=GW / GH), materials=scene.materials, lights=scene.lights,
    game_objects=scene.game_objects)
gcam = {k: jnp.asarray(v) for k, v in gate_scene.camera.device_params().items()}
gate_cfg = cfg.replace(width=GW, height=GH, spp=1)
xla_cfg = gate_cfg.replace(kernels="xla")
t0 = time.perf_counter()
# the XLA oracle render is slow at this scene size — cache it on disk keyed
# by scene content + gate geometry (the oracle itself never changes)
import hashlib

tf_hash = hashlib.sha256(gate_scene.transforms().tobytes()).hexdigest()[:8]
oracle_path = os.path.join(
    ".rayzen_cache",
    f"oracle_{gate_scene.geometry_hash()}_{tf_hash}_{GW}x{GH}"
    f"_{xla_cfg.max_bounces}.npz",
)
if os.path.exists(oracle_path):
    oracle = np.load(oracle_path)["image"].astype(np.float32)
else:
    oracle = np.asarray(
        render_radiance(pack_scene(gate_scene, xla_cfg), gcam, xla_cfg)
    )
    os.makedirs(".rayzen_cache", exist_ok=True)
    np.savez_compressed(oracle_path, image=oracle.astype(np.float16))
if mode == "chunked":
    gate_chunks = tuple(
        pack_scene(c, gate_cfg) for c in partition_scene(gate_scene, CHUNK_TRIS)
    )
    gate_img = np.asarray(
        render_radiance_chunked(gate_chunks, gcam, gate_cfg)
    )
else:
    gate_img = np.asarray(
        render_radiance(pack_scene(gate_scene, gate_cfg), gcam, gate_cfg)
    )
gate_s = ssim(gate_img, oracle)
print(f"# correctness gate [{mode}]: SSIM {gate_s:.4f} vs XLA oracle "
      f"({GW}x{GH}, {time.perf_counter() - t0:.0f} s)", file=sys.stderr)
if gate_s < 0.98:
    print(f"BENCH REFUSED: {mode} SSIM {gate_s:.4f} < 0.98 vs the XLA "
          "oracle — fix correctness first", file=sys.stderr)
    sys.exit(1)

t0 = time.perf_counter()
img, rays = fn(arrays_in, cam)
np.asarray(img)
print(f"# compile+first: {time.perf_counter() - t0:.1f} s, {detail}",
      file=sys.stderr)

times = []
for _ in range(int(os.environ.get("RAYZEN_LARGE_REPS", "5"))):
    t0 = time.perf_counter()
    img, rays = jax.block_until_ready(fn(arrays_in, cam))
    times.append(time.perf_counter() - t0)
med = float(np.median(times))
mrays = int(rays) / med / 1e6
print(f"# {total_tris} tris [{mode}] on {jax.devices()[0].device_kind}: "
      f"{med / SPP * 1e3:.1f} ms/sample, {mrays:.1f} Mrays/s (median of "
      f"{len(times)} synced dispatches)", file=sys.stderr)
from rayzen.image_io import write_png

write_png("field.png", np.asarray(img))
print(f"{mrays:.2f}")
