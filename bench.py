"""Benchmark harness: 1080p demo-scene path tracing on one GPU.

The reference publishes no numbers (BASELINE.md) — this creates the harness it
lacked, following its methodology: warmup frames before measurement
(main.cpp:1324-1354) and per-frame breakdowns (main.cpp:656-664). The headline
metric is Mrays/s, counting *actually traced* rays (primary + bounce waves +
shadow re-casts) measured on device, not a flattering upper bound.

A run that finds no GPU fails. Prints the card's name and power limit, then
one JSON line: {"metric", "value", "unit", "device", "card", ...}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"BENCH FAILED: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line

    card = card_line()
    print(f"# device {dev.device_kind}; card {card}", file=sys.stderr)

    from rayzen.cache import setup_compile_cache
    from rayzen.config import RenderConfig
    from rayzen.demo import build_demo_scene
    from rayzen.integrator import render_radiance_with_stats
    from rayzen.packing import pack_scene

    here = os.path.dirname(os.path.abspath(__file__))
    setup_compile_cache()

    # ---- correctness gate: before timing anything, the default path must
    # reproduce the CPU brute-force golden of the demo scene. A fast wrong
    # image must never produce a benchmark number.
    from rayzen.image_io import ssim

    gw, gh = 256, 192
    gate_cfg = RenderConfig(width=gw, height=gh, spp=1, max_bounces=5)
    gate_scene = build_demo_scene(gw, gh)
    gate_arrays = pack_scene(gate_scene, gate_cfg)
    gate_cam = {
        k: jax.numpy.asarray(v)
        for k, v in gate_scene.camera.device_params().items()
    }
    golden = np.load(os.path.join(here, "tests", "golden", "demo_256x192.npz"))[
        "image"
    ].astype(np.float32)
    gate_img = np.asarray(
        jax.jit(
            lambda a, c: render_radiance_with_stats(a, c, gate_cfg)
        )(gate_arrays, gate_cam)[0]
    )
    gate_ssim = ssim(gate_img, golden)
    print(f"# correctness gate: SSIM {gate_ssim:.4f} vs CPU golden (256x192)",
          file=sys.stderr)
    if gate_ssim < 0.995:
        print(
            f"BENCH REFUSED: render SSIM {gate_ssim:.4f} < 0.995 vs "
            "tests/golden/demo_256x192.npz — fix correctness first",
            file=sys.stderr,
        )
        return 1

    # second gate at the reference's native 800x600 (main.cpp:35-36): one
    # extra dispatch against the parity anchor, so the headline number can
    # never come from an image that only holds up at thumbnail size.
    aw, ah = 800, 600
    a_cfg = RenderConfig(width=aw, height=ah, spp=1, max_bounces=5)
    a_scene = build_demo_scene(aw, ah)
    a_arrays = pack_scene(a_scene, a_cfg)
    a_cam = {
        k: jax.numpy.asarray(v)
        for k, v in a_scene.camera.device_params().items()
    }
    anchor = np.load(
        os.path.join(here, "tests", "golden", "demo_reference_800x600.npz")
    )["image"].astype(np.float32)
    a_img = np.asarray(
        jax.jit(
            lambda a, c: render_radiance_with_stats(a, c, a_cfg)
        )(a_arrays, a_cam)[0]
    )
    a_ssim = ssim(a_img, anchor)
    print(f"# correctness gate: SSIM {a_ssim:.4f} vs CPU golden (800x600)",
          file=sys.stderr)
    if a_ssim < 0.995:
        print(
            f"BENCH REFUSED: render SSIM {a_ssim:.4f} < 0.995 vs "
            "tests/golden/demo_reference_800x600.npz — fix correctness first",
            file=sys.stderr,
        )
        return 1

    width, height = 1920, 1080
    # samples per dispatch (env-overridable for amortization experiments)
    spp = int(os.environ.get("RAYZEN_BENCH_SPP", "64"))
    # samples accumulate on device in one dispatch (lax.fori_loop): this
    # measures sustained render throughput, the number that matters for
    # progressive/offline rendering
    cfg = RenderConfig(width=width, height=height, spp=spp, max_bounces=5)
    scene = build_demo_scene(width, height)
    arrays = pack_scene(scene, cfg)
    cam = {k: jax.numpy.asarray(v) for k, v in scene.camera.device_params().items()}

    fn = jax.jit(lambda a, c: render_radiance_with_stats(a, c, cfg))

    # warmup: compile + 1 steady dispatch (reference --warmup-frames
    # methodology)
    t0 = time.perf_counter()
    img, rays = fn(arrays, cam)
    np.asarray(img)
    compile_s = time.perf_counter() - t0
    img, rays = fn(arrays, cam)
    np.asarray(img)

    # dispatches stay in flight (issue all, then sync all); the metric is the
    # mean over all of them. A best window of a few dispatches is no metric
    # on a GPU: the dispatch calls return only after much of their work has
    # run, so late windows time the readback of finished frames (on an H100
    # one read 28,301.98 Mrays/s). ROADMAP S2 replaces this mean with the
    # median of synced dispatches.
    dispatches = 10
    t0 = time.perf_counter()
    results = [fn(arrays, cam) for _ in range(dispatches)]
    total_rays = 0
    for img, rays in results:
        total_rays += int(rays)
        np.asarray(img)
    wall = time.perf_counter() - t0

    frame_ms = wall / dispatches / spp * 1e3
    mrays = total_rays / wall / 1e6
    print(
        f"# mean of {dispatches} in-flight dispatches x {spp} spp @ "
        f"{width}x{height}, {cfg.max_bounces} bounces on {dev.device_kind} "
        f"({card}): {frame_ms:.3f} ms per 1-spp frame equivalent, "
        f"{total_rays // dispatches} rays/dispatch, compile {compile_s:.1f}s",
        file=sys.stderr,
    )
    print(f"card: {card}")
    print(
        json.dumps(
            {
                "metric": "Mrays/s (1080p demo scene, 5 bounces, sustained)",
                "value": round(mrays, 2),
                "unit": "Mrays/s",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "card": card,
                "spp": spp,
                "sha": _git_sha(),
                "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
