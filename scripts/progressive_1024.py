"""BASELINE config 4: progressive accumulation of the demo scene to 1024 spp
on the device, recording convergence (variance vs accumulated spp).

Drives the real Renderer accumulation path (renderer.py render_frame with
cfg.accumulate=True — the reference's progressive mode, main.cpp:612-622 frame
blending) for 1024/spp frames, measuring after each frame the mean-squared
difference of the running average against the final 1024-spp image. For a
Monte-Carlo estimator averaging n samples the error variance decays as 1/n;
the recorded table lets the doc assert that slope.

Usage: python scripts/progressive_1024.py [out.md]
Writes progressive_1024.md (table + PNG) in the working directory by default.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rayzen.config import RenderConfig
from rayzen.demo import build_demo_scene
from rayzen.image_io import write_png
from rayzen.renderer import Renderer

OUT = sys.argv[1] if len(sys.argv) > 1 else "progressive_1024.md"
# env knobs exist so the whole script is CPU-smokeable end to end
W = int(os.environ.get("PROG_W", 800))  # reference native res (main.cpp:35-36)
H = int(os.environ.get("PROG_H", 600))
SPP_PER_FRAME = int(os.environ.get("PROG_SPP", 64))  # in-kernel per dispatch
TOTAL_SPP = int(os.environ.get("PROG_TOTAL", 1024))
FRAMES = TOTAL_SPP // SPP_PER_FRAME

cfg = RenderConfig(width=W, height=H, spp=SPP_PER_FRAME, max_bounces=5,
                   accumulate=True)
scene = build_demo_scene(W, H)
r = Renderer(scene, cfg, async_compile=False)

frames = []
times = []
for i in range(FRAMES):
    t0 = time.perf_counter()
    img = r.render_frame(mode="pt")
    times.append(time.perf_counter() - t0)
    frames.append(img)
    print(f"# frame {i}: {(i + 1) * SPP_PER_FRAME} spp accumulated, "
          f"{times[-1] * 1e3:.0f} ms", file=sys.stderr, flush=True)

final = frames[-1]
rows = []
for i, img in enumerate(frames):
    mse = float(np.mean((img - final) ** 2))
    rows.append(((i + 1) * SPP_PER_FRAME, mse, times[i]))

os.makedirs(os.path.dirname(OUT), exist_ok=True)
png = os.path.join(os.path.dirname(OUT), "images", "progressive_1024.png")
os.makedirs(os.path.dirname(png), exist_ok=True)
write_png(png, final)

with open(OUT, "w") as f:
    f.write(
        "# Progressive accumulation to 1024 spp (BASELINE config 4)\n\n"
        f"Demo scene, {W}x{H}, 5 bounces, {SPP_PER_FRAME} spp per dispatch "
        f"(accumulated in-kernel), {FRAMES} frames on "
        "the device. MSE is measured against the final 1024-spp image; for "
        "a Monte-Carlo average of n samples it should decay ~1/n (doubling "
        "spp halves it) until it hits the shared-tail floor (the final image "
        "contains the earlier samples, so the last rows are correlated).\n\n"
        "| accumulated spp | MSE vs final | frame s |\n|---|---|---|\n"
    )
    for spp, mse, dt in rows:
        f.write(f"| {spp} | {mse:.3e} | {dt:.2f} |\n")
    half = [(rows[i][1], rows[2 * i + 1][1]) for i in range(FRAMES // 4)]
    ratios = [a / b for a, b in half if b > 0]
    f.write(
        f"\nMean MSE ratio when doubling spp (first quarter, uncorrelated "
        f"regime): {np.mean(ratios):.2f} (ideal 2.0 for 1/n decay).\n\n"
        f"![final](images/progressive_1024.png)\n"
    )
print(f"wrote {OUT}; doubling-ratio {np.mean(ratios):.2f}")
