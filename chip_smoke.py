"""Smoke test of the renderer on one GPU, through the entry points a user calls.

    python3 chip_smoke.py             # one card: every phase below
    python3 chip_smoke.py --cards 4   # four cards: the sharded render only

Phases (one card), each fatal on failure:
  1. device  — JAX must find a GPU; prints its kind, name and power limit.
  2. gates   — the demo on the default path at 256x192 and 800x600 must reach
               SSIM >= 0.995 against the CPU brute-force goldens.
  3. walk    — the GPU walk kernel against the XLA walk on the 1080p demo's
               primary, first-bounce and shadow rays.
  4. main    — Renderer at 1920x1080, 5 bounces, path tracer only: compile
               time, median frame time, Mrays/s and peak device memory.
  5. off-path — deforming geometry (LBVH rebuilt on device) and a chunked
               scene, each against the XLA walk.
  6. card tests — the tests marked ``gpu``, run by pytest in this process.

With ``--cards 4`` only the render sharded over four cards runs, against
the same frame on one card. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SSIM_GATE = 0.995
# walk parity against the XLA walk: the residual is FMA contraction that
# differs between the two compilers
TRI_AGREE_MIN = 0.9999
T_REL_TOL = 1e-4
VIS_TOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(line.strip() for line in out.splitlines()) or "unknown"


def camera(scene):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}


def demo(width, height, **cfg_kw):
    from rayzen.config import RenderConfig
    from rayzen.demo import build_demo_scene
    from rayzen.packing import pack_scene

    cfg = RenderConfig(width=width, height=height, **cfg_kw)
    scene = build_demo_scene(width, height)
    return cfg, scene, pack_scene(scene, cfg)


def phase_gates():
    import jax
    import numpy as np

    from rayzen.image_io import ssim
    from rayzen.integrator import render_radiance_with_stats

    for (w, h), golden in (
        ((256, 192), "demo_256x192.npz"),
        ((800, 600), "demo_reference_800x600.npz"),
    ):
        cfg, scene, arrays = demo(w, h, spp=1, max_bounces=5)
        fn = jax.jit(lambda a, c, cfg=cfg: render_radiance_with_stats(a, c, cfg))
        img, rays = fn(arrays, camera(scene))
        img = np.asarray(img)
        ref = np.load(os.path.join(HERE, "tests", "golden", golden))["image"]
        s = ssim(img, ref.astype(np.float32))
        print(f"gate {w}x{h}: SSIM {s:.6f} vs {golden}, rays {int(rays)}")
        check(np.isfinite(img).all(), f"gate {w}x{h}: non-finite pixels")
        check(s >= SSIM_GATE, f"gate {w}x{h}: SSIM {s:.6f} < {SSIM_GATE}")


def walk_rays(width=1920, height=1080):
    """The 1080p demo's primary rays, first-bounce rays and shadow rays toward
    each light, in the renderer's tile order, with the XLA walk's hits."""
    import jax
    import jax.numpy as jnp

    from rayzen.integrator import _swizzled_grid
    from rayzen.ops.camera_rays import generate_rays
    from rayzen.ops.intersect import dot3, normalize
    from rayzen.ops.shade import hemisphere_direction
    from rayzen.ops.traverse import traverse_world
    from rayzen.packing import world_geometry

    cfg, scene, arrays = demo(width, height)
    cam = camera(scene)
    ws = jax.jit(world_geometry)(arrays)
    _, uv, _ = _swizzled_grid(cfg)
    o, d = generate_rays(uv, jnp.zeros_like(uv), cam["inv_proj"],
                         cam["inv_view"], cam["position"])
    act = jnp.ones((o.shape[0],), bool)
    hit = jax.jit(traverse_world)(ws, o, d, act)
    u, v = jax.random.uniform(jax.random.key(0), (2, o.shape[0]))
    d2 = hemisphere_direction(hit.normal, u, v)
    push = jnp.where(dot3(d2, hit.normal) > 0.0, 1.0, -1.0)
    o2 = hit.point + hit.normal * (push * 0.003)[:, None]
    shadows = []
    for light in scene.lights:
        posdir = jnp.asarray(light.position_or_direction[:3], jnp.float32)
        if light.position_or_direction[3] == 1.0:  # point light
            to_l = posdir[None, :] - hit.point
            dist = jnp.sqrt(dot3(to_l, to_l))
            ldir = normalize(to_l, eps=1e-20)
        else:
            ldir = jnp.broadcast_to(normalize(posdir), hit.point.shape)
            dist = jnp.full((o.shape[0],), 1e30, jnp.float32)
        shadows.append((hit.point + ldir * 1e-3, ldir, dist, hit.found))
    return ws, [("primary", o, d, act), ("bounce", o2, d2, hit.found)], shadows


def phase_walk(ws, waves, shadows):
    import jax
    import numpy as np

    from rayzen.ops import traverse, walk

    ref_hit = jax.jit(traverse.traverse_world)
    got_hit = jax.jit(walk.closest_hit)
    for name, o, d, act in waves:
        ref, got = ref_hit(ws, o, d, act), got_hit(ws, o, d, act)
        tri_r, tri_g = np.asarray(ref.tri), np.asarray(got.tri)
        agree = tri_r == tri_g
        both = agree & (tri_r >= 0)
        t_r, t_g = np.asarray(ref.t)[both], np.asarray(got.t)[both]
        rel = float(np.max(np.abs(t_r - t_g) / t_r)) if both.any() else 0.0
        frac = float(agree.mean())
        print(f"walk {name}: {o.shape[0]} rays, {int((tri_r >= 0).sum())} hits,"
              f" tri agreement {frac:.7f}, max |dt|/t {rel:.3e}")
        check(frac >= TRI_AGREE_MIN, f"walk {name}: tri agreement {frac}")
        check(rel <= T_REL_TOL, f"walk {name}: |dt|/t {rel:.3e}")
    ref_sh = jax.jit(traverse.shadow_walk)
    got_sh = jax.jit(walk.shadow_walk)
    for i, (o, d, dist, act) in enumerate(shadows):
        v_r, n_r = ref_sh(ws, o, d, dist, act)
        v_g, n_g = got_sh(ws, o, d, dist, act)
        diff = float(np.max(np.abs(np.asarray(v_r) - np.asarray(v_g))))
        print(f"walk shadow light {i}: {int(n_g)} rays, max |dvis| {diff:.3e}")
        check(int(n_r) == int(n_g), f"shadow light {i}: ray counts differ")
        check(diff <= VIS_TOL, f"shadow light {i}: |dvis| {diff:.3e}")


def phase_main(card):
    import jax
    import numpy as np

    from rayzen.config import RenderConfig
    from rayzen.demo import build_demo_scene
    from rayzen.renderer import Renderer

    w, h, frames = 1920, 1080, 6
    cfg = RenderConfig(width=w, height=h, max_bounces=5, log_level="error")
    scene = build_demo_scene(w, h)
    t0 = time.perf_counter()
    r = Renderer(scene, cfg.replace(path_tracer_only=True))
    compile_s = time.perf_counter() - t0
    times, rays = [], []
    for i in range(frames):
        t0 = time.perf_counter()
        img = r.render_frame()
        dt = time.perf_counter() - t0
        rec = r.profiler.history[-1]
        n = int(round(rec.get("mrays_per_s", 0.0) * rec["total"] * 1e3))
        check(img.shape == (h, w, 3), f"frame {i}: shape {img.shape}")
        check(np.isfinite(img).all(), f"frame {i}: non-finite pixels")
        check(float(img.max()) > 0.0, f"frame {i}: blank image")
        check(n > 0, f"frame {i}: no rays counted")
        if i > 0:  # frame 0 renders at the bounce-1 budget (main.cpp:600)
            times.append(dt)
            rays.append(n)
    med = statistics.median(times)
    mrays = statistics.median(rays) / med / 1e6
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
    print(f"main 1920x1080 5 bounces [{card}]: Renderer set-up incl. compile "
          f"{compile_s:.2f} s; median frame {med * 1e3:.2f} ms over "
          f"{len(times)} frames; {mrays:.2f} Mrays/s; "
          f"{statistics.median(rays)} rays/frame; peak device memory "
          f"{peak / 2**20:.1f} MiB")


def _agree(name, img, ref):
    import numpy as np

    from rayzen.image_io import ssim

    img, ref = np.asarray(img), np.asarray(ref)
    off = float(np.mean(np.abs(img - ref) > 1e-3))
    s = ssim(img, ref)
    print(f"{name}: SSIM {s:.6f} vs the XLA walk, {off:.2e} of pixels off")
    check(np.isfinite(img).all(), f"{name}: non-finite pixels")
    check(s >= SSIM_GATE and off <= 1e-3, f"{name}: differs from the XLA walk")


def phase_off_path():
    import jax
    import jax.numpy as jnp

    from rayzen.deform import render_deforming
    from rayzen.packing import world_geometry
    from rayzen.renderer import Renderer

    # deforming geometry: the demo's world triangles under a travelling
    # wave, with the LBVH rebuilt on device every frame
    cfg, scene, arrays = demo(320, 180, max_bounces=3)
    cam = camera(scene)
    ws = jax.jit(world_geometry)(arrays)
    base = jnp.stack(
        [ws.tri_v0, ws.tri_v0 + ws.tri_e1, ws.tri_v0 + ws.tri_e2], axis=1
    )  # (T, 3, 3)

    def frame(kernels, t):
        verts = base.at[..., 1].add(0.05 * jnp.sin(3.0 * base[..., 0] + t))
        fn = jax.jit(lambda v, c: render_deforming(
            v, ws.tri_mat, ws.materials, ws.lights, c,
            cfg.replace(kernels=kernels), with_stats=True))
        return fn(verts, cam)

    for t in (0.0, 0.5):
        img, n = frame("auto", t)
        ref, _ = frame("xla", t)
        _agree(f"deform t={t} ({base.shape[0]} tris, {int(n)} rays)", img, ref)

    # chunked scene: the demo split into trees of <= 1500 world triangles
    cfg, scene, _ = demo(320, 180, max_bounces=3, log_level="error")
    chunked = Renderer(scene, cfg.replace(chunk_tris=1500, path_tracer_only=True),
                       use_cache=False)
    check(chunked.arrays_list is not None, "chunked: scene was not split")
    img = chunked.render_frame()
    one = Renderer(scene, cfg.replace(kernels="xla", path_tracer_only=True),
                   use_cache=False)
    _agree(f"chunked ({len(chunked.arrays_list)} trees)", img, one.render_frame())


def phase_card_tests():
    """The tests marked ``gpu`` (tests/conftest.py), in this process."""
    import pytest

    class Passes:
        n = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.n += 1

    passes = Passes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")], plugins=[passes])
    print(f"card tests: {passes.n} passed, pytest exit code {rc}")
    check(rc == 0 and passes.n > 0, "card tests did not all pass")


def phase_cards(n_cards, card):
    import jax
    import numpy as np

    from rayzen.integrator import render_radiance_with_stats
    from rayzen.parallel import make_mesh, render_radiance_sharded

    devs = jax.devices()
    check(len(devs) >= n_cards, f"{n_cards} cards wanted, {len(devs)} found")
    cfg, scene, arrays = demo(1920, 1080, max_bounces=5)
    cam = camera(scene)
    mesh = make_mesh(n_cards)
    sharded = jax.jit(lambda a, c: render_radiance_sharded(
        a, c, cfg, mesh, with_stats=True))
    single = jax.jit(lambda a, c: render_radiance_with_stats(a, c, cfg))
    img_s, rays_s = sharded(arrays, cam)
    img_1, rays_1 = single(arrays, cam)
    times = {"sharded": [], "one card": []}
    for name, fn in (("sharded", sharded), ("one card", single)) * 5:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arrays, cam))
        times[name].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    diff = float(np.max(np.abs(np.asarray(img_s) - np.asarray(img_1))))
    print(f"sharded 1920x1080 5 bounces over {n_cards} cards [{card}]: "
          f"max |diff| {diff:.3e} vs one card, rays {int(rays_s)} vs "
          f"{int(rays_1)}, median frame {med['sharded']:.3f} ms sharded, "
          f"{med['one card']:.3f} ms on one card (5 synced dispatches each)")
    check(diff <= 1e-5, f"sharded: max |diff| {diff:.3e} > 1e-5")
    check(int(rays_s) == int(rays_1), "sharded: ray counts differ")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = p.parse_args(argv)
    try:
        check(os.path.isdir(os.path.join(HERE, "rayzen")),
              "the rayzen package is not beside this script")
        sys.path.insert(0, HERE)
        os.environ.setdefault("JAX_PLATFORMS", "cuda")
        import jax

        devs = jax.devices()
        check(devs[0].platform == "gpu",
              f"no GPU: JAX found {devs[0].platform} devices")
        from rayzen.cache import setup_compile_cache

        card = card_line()
        print(f"device: {devs[0].device_kind} x{len(devs)}; card: {card}")
        print(f"compile cache: {setup_compile_cache()}")
        phases = (
            [("cards", lambda: phase_cards(args.cards, card))]
            if args.cards > 1 else [
                ("gates", phase_gates),
                ("walk", lambda: phase_walk(*walk_rays())),
                ("main", lambda: phase_main(card)),
                ("off-path", phase_off_path),
                ("card tests", phase_card_tests),
            ]
        )
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            print(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
        print(f"card: {card}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    result = {
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
