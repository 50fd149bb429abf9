"""Walk trial on one GPU: the Pallas walk (ops/walk.py) against the XLA walk.

Checks the walk against the XLA walk on the 1080p demo's rays (the parity
phase of chip_smoke.py), times each closest-hit walk alone on those rays for
a few block sizes, then times whole frames through
``render_radiance_with_stats`` at 1920x1080, 5 bounces, with
``kernels="xla"`` and ``kernels="walk"``: compiled and warmed first, then
synced dispatches in the order xla, walk, walk, xla, and the median of each.

    python scripts/walk_trial.py [dispatches_per_turn]
"""

import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from rayzen.integrator import render_radiance_with_stats  # noqa: E402
from rayzen.ops import traverse, walk  # noqa: E402


def timed(fn, *args, n=10):
    jax.block_until_ready(fn(*args))  # compile + warm
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def main():
    turn = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform}")
    card = chip_smoke.card_line()
    print(f"device {dev.device_kind}; card {card}")
    ws, waves, shadows = chip_smoke.walk_rays()
    chip_smoke.phase_walk(ws, waves, shadows)

    for name, o, d, act in waves:
        ms = statistics.median(timed(jax.jit(traverse.traverse_world),
                                     ws, o, d, act)) * 1e3
        print(f"closest-hit {name}: xla walk {ms:.3f} ms [{card}]")
        for block in (64, 128, 256):
            walk.BLOCK, walk.NUM_WARPS = block, block // 32
            fn = jax.jit(walk.closest_hit)
            ms = statistics.median(timed(fn, ws, o, d, act)) * 1e3
            print(f"closest-hit {name}: walk block {block} {ms:.3f} ms")
        walk.BLOCK, walk.NUM_WARPS = 128, 4
    o, d, dist, act = shadows[0]
    for label, fn in (("xla", traverse.shadow_walk), ("walk", walk.shadow_walk)):
        ms = statistics.median(timed(jax.jit(fn), ws, o, d, dist, act)) * 1e3
        print(f"shadow light 0: {label} {ms:.3f} ms")

    cfg, scene, arrays = chip_smoke.demo(1920, 1080, max_bounces=5)
    cam = chip_smoke.camera(scene)
    fns, times, rays = {}, {"xla": [], "walk": []}, {}
    for k in ("xla", "walk"):
        c = cfg.replace(kernels=k)
        fns[k] = jax.jit(lambda a, cm, c=c: render_radiance_with_stats(a, cm, c))
        t0 = time.perf_counter()
        lowered = fns[k].lower(arrays, cam)
        compiled = lowered.compile()
        print(f"frame {k}: compile {time.perf_counter() - t0:.2f} s; "
              f"{compiled.memory_analysis()}")
        img, n = jax.block_until_ready(fns[k](arrays, cam))
        rays[k] = int(n)
    for k in ("xla", "walk", "walk", "xla"):
        for _ in range(turn):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[k](arrays, cam))
            times[k].append(time.perf_counter() - t0)
    for k in ("xla", "walk"):
        med = statistics.median(times[k])
        print(f"frame 1920x1080 5 bounces kernels={k}: median {med * 1e3:.3f} ms "
              f"over {len(times[k])} synced dispatches, {rays[k]} rays, "
              f"{rays[k] / med / 1e6:.2f} Mrays/s [{card}]; all ms: "
              + " ".join(f"{t * 1e3:.2f}" for t in times[k]))


if __name__ == "__main__":
    main()
