"""Mouse picking: map a pixel to the triangle/instance under the cursor.

Reference: in BLAS-debug mode the reference unprojects the cursor and runs a
brute-force Möller–Trumbore over *every triangle of every object* on the CPU
each frame to select (instance, triangle) for the branch-visualization overlay
(RayZen/src/main.cpp:502-552). Here the same query is one batched device
intersection over the world-space soup — exact, and microscopic next to a frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.camera_rays import generate_rays
from .ops.traverse import brute_force_world
from .packing import SceneArrays, world_geometry


@jax.jit
def _pick_device(arrays, uv, inv_proj, inv_view, position):
    """The whole pick query as ONE jitted dispatch (unjitted, each jnp op
    would be a separate device dispatch)."""
    origin, direction = generate_rays(
        uv, jnp.zeros_like(uv), inv_proj, inv_view, position
    )
    ws = world_geometry(arrays)
    hit = brute_force_world(ws, origin, direction, jnp.ones(1, bool))
    return hit.found[0], hit.tri[0], hit.inst[0], hit.t[0], hit.point[0]


def pick(
    arrays: SceneArrays,
    camera_params: dict,
    pixel_xy: Tuple[float, float],
    resolution: Tuple[int, int],
) -> Optional[dict]:
    """Pick at a pixel (x, y) in GL window coordinates (origin bottom-left).

    Returns None on a miss, else a dict with instance, triangle (index into the
    instance's packed leaf-order soup — directly usable as
    RenderConfig.debug_selected_tri), world t, and the hit point."""
    width, height = resolution
    uv = jnp.asarray(
        [[(pixel_xy[0] + 0.5) / width, (pixel_xy[1] + 0.5) / height]],
        dtype=jnp.float32,
    )
    found, tri, inst_, t, point = _pick_device(
        arrays,
        uv,
        camera_params["inv_proj"],
        camera_params["inv_view"],
        camera_params["position"],
    )
    if not bool(found):
        return None
    world_tri = int(tri)
    inst = int(inst_)
    # world-tri index -> index within the instance's triangle range
    wtri_inst = np.asarray(arrays.wtri_inst)
    first_of_inst = int(np.argmax(wtri_inst == inst))
    return dict(
        instance=inst,
        triangle=world_tri - first_of_inst,
        t=float(t),
        point=np.asarray(point),
    )


def pick_chunks(
    arrays_list,
    camera_params: dict,
    pixel_xy: Tuple[float, float],
    resolution: Tuple[int, int],
) -> Optional[dict]:
    """Pick across a chunked scene (bigscene.partition_scene): runs the pick
    query per chunk and keeps the closest hit, so geometry outside chunk 0 is
    pickable too. The returned dict gains a "chunk" key; "instance"/"triangle"
    index within that chunk's packed arrays."""
    best = None
    for ci, arrays in enumerate(arrays_list):
        hit = pick(arrays, camera_params, pixel_xy, resolution)
        if hit is not None and (best is None or hit["t"] < best["t"]):
            hit["chunk"] = ci
            best = hit
    return best
