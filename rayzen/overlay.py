"""Debug overlays: BVH wireframes, light markers, FPS readout.

Reference: the in-shader overlay suite (fragment_shader.glsl) — TLAS leaf
wireframes colored by instance (overlayBVHWireframe :310-373), BLAS root boxes,
selected-triangle root-to-leaf branch visualization (findBVHBranchIterative
:257-307), point-light screen markers (:782-803), and an 8x8 bitmap-font FPS
readout (:118-183, :805-819). Rebuilt as composable post-passes over the rendered
framebuffer: each pass is dense per-pixel VPU math (distance-to-segment fields for
wireframes), with the tiny host-side parts (branch search over the static BVH)
done in numpy.

Faithfully-kept reference quirks: mode-0 BLAS root boxes are drawn in *object*
space without the instance transform (glsl:335-344), and mode-1 branch boxes
transform only the min/max corners (glsl:365-366) — both reproduced as-is for
parity. The FPS font uses this repo's own glyph bitmaps (same 8x8, LSB-left
format) rather than the reference's table.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .packing import HIGHEST, SceneArrays, instance_world_aabbs

# 8x8 digit glyphs, rows top-to-bottom, bit 7 = leftmost pixel. Chars: 0-9, '.'
FONT = np.asarray(
    [
        [0x3C, 0x42, 0x46, 0x5A, 0x62, 0x42, 0x3C, 0x00],  # 0
        [0x08, 0x18, 0x28, 0x08, 0x08, 0x08, 0x3E, 0x00],  # 1
        [0x3C, 0x42, 0x02, 0x0C, 0x30, 0x40, 0x7E, 0x00],  # 2
        [0x3C, 0x42, 0x02, 0x1C, 0x02, 0x42, 0x3C, 0x00],  # 3
        [0x04, 0x0C, 0x14, 0x24, 0x7E, 0x04, 0x04, 0x00],  # 4
        [0x7E, 0x40, 0x7C, 0x02, 0x02, 0x42, 0x3C, 0x00],  # 5
        [0x1C, 0x20, 0x40, 0x7C, 0x42, 0x42, 0x3C, 0x00],  # 6
        [0x7E, 0x02, 0x04, 0x08, 0x10, 0x10, 0x10, 0x00],  # 7
        [0x3C, 0x42, 0x42, 0x3C, 0x42, 0x42, 0x3C, 0x00],  # 8
        [0x3C, 0x42, 0x42, 0x3E, 0x02, 0x04, 0x38, 0x00],  # 9
        [0x00, 0x00, 0x00, 0x00, 0x00, 0x18, 0x18, 0x00],  # .
    ],
    dtype=np.int32,
)

_EDGES = np.asarray(
    [0, 1, 1, 2, 2, 3, 3, 0, 4, 5, 5, 6, 6, 7, 7, 4, 0, 4, 1, 5, 2, 6, 3, 7],
    dtype=np.int64,
).reshape(12, 2)

_CORNER_SEL = np.asarray(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.float32,
)  # matches aabbWireframe corner order (glsl:231-239)


def hsv2rgb(h, s, v):
    """hsv2rgb (glsl:215-219), scalar numpy."""
    h = np.asarray(h, np.float64)
    p = np.abs((h + np.asarray([1.0, 2.0 / 3.0, 1.0 / 3.0])) % 1.0 * 6.0 - 3.0)
    return (v * ((1.0 - s) + s * np.clip(p - 1.0, 0.0, 1.0))).astype(np.float32)


def _box_corners(bmin, bmax):
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    return bmin * (1.0 - _CORNER_SEL) + bmax * _CORNER_SEL  # (8, 3)


@functools.partial(jax.jit, static_argnames=("thickness",))
def _wireframe_scan(frag, corners, colors, vp, res, thickness):
    """Jitted core: lax.scan over stacked boxes, preserving the reference's
    sequential mix/max accumulation (glsl:318-344)."""

    def one_box(carry, box):
        wire, color = carry
        c, bcol = box  # (8, 3), (3,)
        hom = jnp.concatenate([c, jnp.ones((8, 1), jnp.float32)], axis=1)
        clip = jnp.matmul(hom, vp.T, precision=HIGHEST)  # (8, 4)
        w = clip[:, 3]
        screen = (clip[:, :2] / w[:, None] * 0.5 + 0.5) * res  # (8, 2)
        a = screen[_EDGES[:, 0]]  # (12, 2)
        b = screen[_EDGES[:, 1]]
        seg_ok = (w[_EDGES[:, 0]] > 0.0) & (w[_EDGES[:, 1]] > 0.0)
        ab = b - a
        denom = jnp.maximum(jnp.sum(ab * ab, axis=1), 1e-12)
        pa = frag[:, None, :] - a[None, :, :]
        t = jnp.clip(jnp.sum(pa * ab[None], axis=-1) / denom[None], 0.0, 1.0)
        proj = a[None] + t[..., None] * ab[None]
        d = jnp.linalg.norm(frag[:, None, :] - proj, axis=-1)
        d = jnp.where(seg_ok[None], d, 1e6)
        hit = (jnp.min(d, axis=1) < thickness).astype(jnp.float32)
        color = color * (1.0 - hit[:, None]) + bcol[None] * hit[:, None]
        wire = jnp.maximum(wire, hit)
        return (wire, color), None

    wire0 = frag[:, 0] * 0.0
    color0 = jnp.zeros((frag.shape[0], 3), dtype=jnp.float32)
    (wire, color), _ = jax.lax.scan(one_box, (wire0, color0), (corners, colors))
    return wire, color


def wireframe_pass(frag, boxes, box_colors, view_proj, resolution, thickness):
    """Distance-to-segment wireframe field for a list of AABBs.

    frag: (P, 2) pixel coords; boxes: list of (corners (8,3)) already in the
    space expected by ``view_proj``; box_colors: list of (3,). Returns
    (wire (P,), color (P, 3))."""
    if not boxes:
        return frag[:, 0] * 0.0, jnp.zeros((frag.shape[0], 3), jnp.float32)
    corners = jnp.asarray(np.stack(boxes)).astype(jnp.float32)  # (B, 8, 3)
    colors = jnp.asarray(np.stack(box_colors)).astype(jnp.float32)  # (B, 3)
    return _wireframe_scan(
        frag,
        corners,
        colors,
        jnp.asarray(view_proj),
        jnp.asarray(resolution, dtype=jnp.float32),
        float(thickness),
    )


def tlas_leaf_boxes(arrays: SceneArrays):
    """World-space instance AABBs + per-instance hue (glsl:316-332). Mode 0."""
    wmin, wmax = instance_world_aabbs(arrays)
    wmin, wmax = np.asarray(wmin), np.asarray(wmax)
    n = arrays.num_instances
    boxes, colors = [], []
    for i, meta in enumerate(arrays.instance_meta):
        if meta.num_triangles == 0:
            continue
        boxes.append(_box_corners(wmin[i], wmax[i]))
        colors.append(hsv2rgb(i / n * 0.5, 1.0, 1.0))
    return boxes, colors


def blas_root_boxes(arrays: SceneArrays):
    """Object-space BLAS root bounds in black — drawn *untransformed* exactly
    like the reference (glsl:335-344). Mode 0."""
    boxes, colors = [], []
    for meta in arrays.instance_meta:
        if meta.num_triangles == 0:
            continue
        nb = np.asarray(arrays.node_bounds[meta.node_offset])
        boxes.append(_box_corners(nb[:3], nb[3:]))
        colors.append(np.zeros(3, np.float32))
    return boxes, colors


def blas_branch_boxes(arrays: SceneArrays, instance: int, triangle: int):
    """Root-to-leaf path for the leaf containing packed triangle ``triangle``
    (relative to the instance's mesh) in the selected BLAS — the host-side
    equivalent of findBVHBranchIterative (glsl:257-307). Boxes transform only
    min/max corners by the instance transform (reference quirk, glsl:365-366);
    colors ramp through hue along the path."""
    meta = arrays.instance_meta[instance]
    if meta.num_triangles == 0 or not (0 <= triangle < meta.num_triangles):
        return [], []
    node_meta = np.asarray(arrays.node_meta)
    node_bounds = np.asarray(arrays.node_bounds)
    xform = np.asarray(arrays.transforms[instance])

    # walk from the root toward the leaf whose contiguous range holds `triangle`
    path = []
    cur = 0
    for _ in range(64):
        path.append(cur)
        row = node_meta[meta.node_offset + cur]
        left_first, count = int(row[0]), int(row[1])
        if count >= 0:
            break
        # children partition the triangle range; right starts where left ends
        right = left_first + 1
        right_first = _subtree_first(node_meta, meta.node_offset, right)
        cur = left_first if triangle < right_first else right

    boxes, colors = [], []
    for i, node in enumerate(path):
        nb = node_bounds[meta.node_offset + node]
        bmin = (xform[:3, :3] @ nb[:3]) + xform[:3, 3]
        bmax = (xform[:3, :3] @ nb[3:]) + xform[:3, 3]
        boxes.append(_box_corners(bmin, bmax))
        colors.append(hsv2rgb(i / len(path), 1.0, 1.0))
    return boxes, colors


def _subtree_first(node_meta, offset, node):
    """First triangle position covered by ``node``'s subtree (leftmost leaf)."""
    cur = node
    for _ in range(64):
        row = node_meta[offset + cur]
        if int(row[1]) >= 0:
            return int(row[0])
        cur = int(row[0])
    return 0


def light_markers_pass(color, frag, arrays: SceneArrays, view_proj, resolution):
    """Point-light screen markers (glsl:782-803): radius-8 circles with a
    2-pixel smoothstep edge, tinted the light's color."""
    res = jnp.asarray(resolution, dtype=jnp.float32)
    vp = jnp.asarray(view_proj)
    lights = np.asarray(arrays.lights)
    for li in range(lights.shape[0]):
        posdir = lights[li, :4]
        if posdir[3] != 1.0:
            continue  # only point lights
        lcol = jnp.asarray(lights[li, 4:7])
        clip = jnp.matmul(
            vp, jnp.asarray([posdir[0], posdir[1], posdir[2], 1.0]),
            precision=HIGHEST,
        )
        w = clip[3]
        screen = (clip[:2] / w * 0.5 + 0.5) * res
        dist = jnp.linalg.norm(frag - screen[None], axis=1)
        radius = 8.0
        # smoothstep(radius, radius - 2, dist)
        t = jnp.clip((radius - dist) / 2.0, 0.0, 1.0)
        alpha = t * t * (3.0 - 2.0 * t)
        alpha = jnp.where(w > 0.0, alpha, 0.0)
        color = color * (1.0 - alpha[:, None]) + lcol[None] * alpha[:, None]
    return color


def fps_pass(color, frag, fps, resolution):
    """FPS readout "HTO.t" at the top-left in 2x-scaled 8x8 glyphs, white on the
    rendered image (glsl:805-819 layout: margin 8, scale 2, 9-px advance)."""
    width, height = resolution
    margin, scale = 8.0, 2.0
    font_h = 8
    pos = jnp.asarray([margin, height - margin - font_h * scale], jnp.float32)
    fps = jnp.asarray(fps, jnp.float32)
    fps_int = jnp.floor(fps).astype(jnp.int32)
    tenths = jnp.floor((fps - fps_int) * 10.0).astype(jnp.int32)
    chars = jnp.stack(
        [
            (fps_int // 100) % 10,
            (fps_int // 10) % 10,
            fps_int % 10,
            jnp.int32(10),  # '.'
            tenths,
        ]
    )
    font = jnp.asarray(FONT).reshape(-1)  # (11*8,)
    coverage = frag[:, 0] * 0.0
    for i in range(5):
        cpos = pos + jnp.asarray([i * 9.0 * scale, 0.0])
        rel = (frag - cpos) / scale
        x = jnp.floor(rel[:, 0]).astype(jnp.int32)
        y = 7 - jnp.floor(rel[:, 1]).astype(jnp.int32)  # flip to top-down rows
        inside = (x >= 0) & (x < 8) & (y >= 0) & (y < 8)
        row = font[chars[i] * 8 + jnp.clip(y, 0, 7)]
        bit = (row >> (7 - jnp.clip(x, 0, 7))) & 1
        coverage = jnp.maximum(coverage, jnp.where(inside, bit.astype(jnp.float32), 0.0))
    white = jnp.ones(3, jnp.float32)
    return color * (1.0 - coverage[:, None]) + white[None] * coverage[:, None]


def apply_overlays(
    image,  # (H, W, 3)
    arrays: SceneArrays,
    camera_params: dict,
    cfg,
    fps: float | None = None,
):
    """Composite the configured debug overlays onto a rendered frame, in the
    reference's order: BVH wireframes (50% blend, glsl:776-779), then light
    markers, then the FPS readout.

    This is the EAGER reference implementation (one device op at a time) —
    convenient for one-off calls and the parity oracle for the jitted
    composite below, which is what the Renderer's frame loop uses."""
    height, width = image.shape[:2]
    from .ops.camera_rays import pixel_grid

    frag, _ = pixel_grid(width, height)
    color = image.reshape(-1, 3)
    view_proj = np.asarray(camera_params["proj"]) @ np.asarray(camera_params["view"])

    if cfg.debug_show_bvh:
        if cfg.debug_bvh_mode == 0:
            tb, tc = tlas_leaf_boxes(arrays)
            bb, bc = blas_root_boxes(arrays)
            t_wire, t_col = wireframe_pass(frag, tb, tc, view_proj, (width, height), 1.5)
            b_wire, b_col = wireframe_pass(frag, bb, bc, view_proj, (width, height), 2.0)
        else:
            pb, pc = blas_branch_boxes(
                arrays, cfg.debug_selected_blas, cfg.debug_selected_tri
            )
            t_wire = frag[:, 0] * 0.0
            t_col = jnp.zeros_like(color)
            b_wire, b_col = wireframe_pass(frag, pb, pc, view_proj, (width, height), 2.0)
        color = color * (1.0 - 0.5 * t_wire[:, None]) + t_col * (0.5 * t_wire[:, None])
        color = color * (1.0 - 0.5 * b_wire[:, None]) + b_col * (0.5 * b_wire[:, None])

    if cfg.debug_show_lights:
        color = light_markers_pass(color, frag, arrays, view_proj, (width, height))

    if cfg.show_fps_overlay and fps is not None:
        color = fps_pass(color, frag, fps, (width, height))

    return jnp.clip(color, 0.0, 1.0).reshape(height, width, 3)


# ---------------------------------------------------------------------------
# Single-dispatch composite.
#
# apply_overlays above issues ~25 eager device ops per frame, each its own
# dispatch. composite_core is the same math as one
# traced function: the Renderer jits it once per (toggle-combo, resolution,
# box-count) and each frame's overlays become ONE dispatch. Branch boxes are
# padded to a fixed width with a validity mask so click-picks change operands,
# never shapes (no recompile per pick). apply_overlays stays as the eager
# reference implementation; test_runtime pins the two paths equal.


def _masked_wireframe_scan(frag, corners, colors, mask, vp, res, thickness):
    """_wireframe_scan with a per-box validity mask (padded slots draw
    nothing); same sequential mix/max accumulation (glsl:318-344)."""

    def one_box(carry, box):
        wire, color = carry
        c, bcol, m = box  # (8, 3), (3,), ()
        hom = jnp.concatenate([c, jnp.ones((8, 1), jnp.float32)], axis=1)
        clip = jnp.matmul(hom, vp.T, precision=HIGHEST)
        w = clip[:, 3]
        screen = (clip[:, :2] / w[:, None] * 0.5 + 0.5) * res
        a = screen[_EDGES[:, 0]]
        b = screen[_EDGES[:, 1]]
        seg_ok = (w[_EDGES[:, 0]] > 0.0) & (w[_EDGES[:, 1]] > 0.0)
        ab = b - a
        denom = jnp.maximum(jnp.sum(ab * ab, axis=1), 1e-12)
        pa = frag[:, None, :] - a[None, :, :]
        t = jnp.clip(jnp.sum(pa * ab[None], axis=-1) / denom[None], 0.0, 1.0)
        proj = a[None] + t[..., None] * ab[None]
        d = jnp.linalg.norm(frag[:, None, :] - proj, axis=-1)
        d = jnp.where(seg_ok[None], d, 1e6)
        hit = (jnp.min(d, axis=1) < thickness).astype(jnp.float32) * m
        color = color * (1.0 - hit[:, None]) + bcol[None] * hit[:, None]
        wire = jnp.maximum(wire, hit)
        return (wire, color), None

    wire0 = frag[:, 0] * 0.0
    color0 = jnp.zeros((frag.shape[0], 3), dtype=jnp.float32)
    (wire, color), _ = jax.lax.scan(
        one_box, (wire0, color0), (corners, colors, mask)
    )
    return wire, color


def _lights_scan(color, frag, lights, vp, res):
    """light_markers_pass as a traced scan: the point-light filter
    (positionOrDirection.w == 1, glsl:783) becomes a traced gate so the light
    array is an operand, not trace-time data."""

    def step(color, lrow):
        posdir = lrow[:4]
        lcol = lrow[4:7]
        clip = jnp.matmul(
            vp, jnp.concatenate([posdir[:3], jnp.ones(1, jnp.float32)]),
            precision=HIGHEST,
        )
        w = clip[3]
        screen = (clip[:2] / w * 0.5 + 0.5) * res
        dist = jnp.linalg.norm(frag - screen[None], axis=1)
        t = jnp.clip((8.0 - dist) / 2.0, 0.0, 1.0)
        alpha = t * t * (3.0 - 2.0 * t)
        alpha = jnp.where((w > 0.0) & (posdir[3] == 1.0), alpha, 0.0)
        return color * (1.0 - alpha[:, None]) + lcol[None] * alpha[:, None], None

    color, _ = jax.lax.scan(step, color, lights)
    return color


def composite_traced(
    image,
    t_corners, t_colors, t_mask,
    b_corners, b_colors, b_mask,
    vp, lights, fps,
    *, use_t, use_b, show_lights, show_fps, width, height,
):
    """All configured overlays in one traced computation, in the reference's
    order (wireframes 50% blend glsl:776-779, then light markers, then FPS).
    Statically-off passes are skipped at trace time; their operands are tiny
    dummies."""
    from .ops.camera_rays import pixel_grid

    frag, _ = pixel_grid(width, height)
    res = jnp.asarray([width, height], jnp.float32)
    color = image.reshape(-1, 3)
    if use_t:
        t_wire, t_col = _masked_wireframe_scan(
            frag, t_corners, t_colors, t_mask, vp, res, 1.5)
        color = color * (1.0 - 0.5 * t_wire[:, None]) + t_col * (0.5 * t_wire[:, None])
    if use_b:
        b_wire, b_col = _masked_wireframe_scan(
            frag, b_corners, b_colors, b_mask, vp, res, 2.0)
        color = color * (1.0 - 0.5 * b_wire[:, None]) + b_col * (0.5 * b_wire[:, None])
    if show_lights:
        color = _lights_scan(color, frag, lights, vp, res)
    if show_fps:
        color = fps_pass(color, frag, fps, (width, height))
    return jnp.clip(color, 0.0, 1.0).reshape(height, width, 3)


# standalone one-dispatch form (used when the composite can't fuse into the
# render program: accumulate mode, preview frames, the bounce-1 first frame)
composite_core = jax.jit(
    composite_traced,
    static_argnames=(
        "use_t", "use_b", "show_lights", "show_fps", "width", "height",
    ),
)


_BRANCH_PAD = 64  # fixed branch-box width: the traversal stack bound (glsl:422)
_DUMMY_BOXES = None


def _dummy_boxes():
    global _DUMMY_BOXES
    if _DUMMY_BOXES is None:
        _DUMMY_BOXES = (
            jnp.zeros((1, 8, 3), jnp.float32),
            jnp.zeros((1, 3), jnp.float32),
            jnp.zeros((1,), jnp.float32),
        )
    return _DUMMY_BOXES


def build_overlay_inputs(arrays: SceneArrays, cfg):
    """Host-side box precompute for composite_core, shaped for zero-recompile
    frames: mode-0 counts are static per scene; mode-1 branch boxes pad to
    _BRANCH_PAD with a mask so every pick reuses one compiled composite.
    Returns ((t_corners, t_colors, t_mask, use_t), (b_...)) with device-
    resident arrays (uploaded once, reused every frame)."""

    def pack(boxes, colors, pad=None):
        n = len(boxes)
        if n == 0:
            return (*_dummy_boxes(), False)
        width = pad if pad is not None else n
        c = np.zeros((width, 8, 3), np.float32)
        col = np.zeros((width, 3), np.float32)
        m = np.zeros((width,), np.float32)
        c[:n] = np.stack(boxes)
        col[:n] = np.stack(colors)
        m[:n] = 1.0
        return jnp.asarray(c), jnp.asarray(col), jnp.asarray(m), True

    if not cfg.debug_show_bvh:
        return (*_dummy_boxes(), False), (*_dummy_boxes(), False)
    if cfg.debug_bvh_mode == 0:
        t = pack(*tlas_leaf_boxes(arrays))
        b = pack(*blas_root_boxes(arrays))
    else:
        t = (*_dummy_boxes(), False)
        b = pack(
            *blas_branch_boxes(
                arrays, cfg.debug_selected_blas, cfg.debug_selected_tri
            ),
            pad=_BRANCH_PAD,
        )
    return t, b
