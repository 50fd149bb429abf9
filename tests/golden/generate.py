"""Regenerate the golden images (CPU backend, deterministic).

Goldens are produced by the BRUTE-FORCE oracle (no BVH) wherever tractable —
the ground truth the reference never shipped (SURVEY.md §4) — chunked over
rays to bound the (R, T) pair matrices. The 800x600 parity anchor (the
reference's default resolution, main.cpp:35-36) uses the XLA BVH path, whose
equality with the oracle is asserted by the brute goldens and
tests/test_render.py.

Run:  JAX_PLATFORMS=cpu python tests/golden/generate.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax.numpy as jnp  # noqa: E402

from rayzen import RenderConfig, pack_scene  # noqa: E402
from rayzen.demo import build_demo_scene  # noqa: E402
from rayzen.integrator import render_rays  # noqa: E402
from rayzen.ops import camera_rays  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def render_chunked(cfg, tracer: str, chunk: int = 4096) -> np.ndarray:
    """Full-frame render in ray chunks (scanline order; per-pixel results are
    chunking-invariant because all sampler state derives from frag/uv)."""
    scene = build_demo_scene(cfg.width, cfg.height)
    arrays = pack_scene(scene, cfg)
    cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
    frag, uv = camera_rays.pixel_grid(cfg.width, cfg.height)
    out = []
    for lo in range(0, frag.shape[0], chunk):
        out.append(
            np.asarray(
                render_rays(
                    arrays, frag[lo : lo + chunk], uv[lo : lo + chunk],
                    cam, cfg, tracer=tracer,
                )
            )
        )
    return np.concatenate(out).reshape(cfg.height, cfg.width, 3)


def main():
    jobs = [
        # (filename, width, height, tracer, chunk)
        ("demo_96x64.npz", 96, 64, "brute", 2048),
        ("demo_256x192.npz", 256, 192, "brute", 2048),
        ("demo_reference_800x600.npz", 800, 600, "bvh", 30000),
    ]
    for name, w, h, tracer, chunk in jobs:
        cfg = RenderConfig(width=w, height=h, spp=1, max_bounces=5, kernels="xla")
        t0 = time.perf_counter()
        img = render_chunked(cfg, tracer, chunk)
        dt = time.perf_counter() - t0
        path = os.path.join(HERE, name)
        np.savez_compressed(path, image=img.astype(np.float16))
        print(f"{name}: {w}x{h} tracer={tracer} in {dt:.1f}s -> {path}")


if __name__ == "__main__":
    main()
