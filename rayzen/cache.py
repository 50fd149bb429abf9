"""Disk caches: packed-scene/BVH arrays (NPZ) and the XLA compilation cache.

Reference (SURVEY.md §5 "Checkpoint / resume"): a three-tier binary cache — per-
mesh BLAS files, TLAS + instances, and the whole SSBO set (main.cpp:913-945,
:951-969, :1039-1045) — plus a shader program-binary cache keyed on source mtimes
(main.cpp:742-798). Here:

- ``cached_pack_scene`` persists the packed SceneArrays keyed by a *content hash*
  of geometry + materials + build config, fixing the reference's object-count-only
  invalidation bug (main.cpp:930-938; SURVEY.md §7). ``--rebuild-bvh`` parity via
  ``force_rebuild``.
- ``setup_compile_cache`` enables JAX's persistent compilation cache — the exact
  analog of the GL program-binary cache (XLA keys on program/flags itself).
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np

from . import logging_util as log
from .config import RenderConfig
from .packing import InstanceMeta, SceneArrays, pack_scene_host
from .scene import Scene

_ARRAY_FIELDS = [
    "tri_v0", "tri_e1", "tri_e2", "tri_mat", "node_bounds", "node_meta",
    "transforms", "inv_transforms", "root_bmin", "root_bmax",
    "inst_mat_override",
    "uni_meta", "blas_src", "blas_inst", "tlas_mask", "wtri_src", "wtri_inst",
    "node_leaf_tri", "materials", "lights",
]


def save_scene_arrays(path: str, arrays: SceneArrays) -> None:
    data = {f: np.asarray(getattr(arrays, f)) for f in _ARRAY_FIELDS}
    meta = np.asarray(
        [
            (m.node_offset, m.tri_offset, m.num_nodes, m.num_triangles, m.mesh_index)
            for m in arrays.instance_meta
        ],
        dtype=np.int64,
    ).reshape(-1, 5)
    data["instance_meta"] = meta
    tmp = path + ".tmp.npz"  # savez appends .npz unless already present
    np.savez_compressed(tmp, **data)
    os.replace(tmp, path)


def load_scene_arrays(path: str) -> SceneArrays:
    with np.load(path) as z:
        kwargs = jax.device_put({f: z[f] for f in _ARRAY_FIELDS})  # one batch
        meta = tuple(InstanceMeta(*(int(x) for x in row)) for row in z["instance_meta"])
    return SceneArrays(instance_meta=meta, **kwargs)


def scene_cache_key(scene: Scene, cfg: RenderConfig) -> str:
    return f"{scene.geometry_hash()}_{cfg.leaf_size}_{cfg.split_method}"


def cached_pack_scene(
    scene: Scene, cfg: RenderConfig, force_rebuild: bool = False
) -> SceneArrays:
    """Pack with a disk cache; transforms are always refreshed from the live
    scene after a cache hit (the reference refreshes transforms too,
    main.cpp:1054-1060)."""
    os.makedirs(cfg.cache_dir, exist_ok=True)
    path = os.path.join(cfg.cache_dir, f"scene_{scene_cache_key(scene, cfg)}.npz")
    if not force_rebuild and os.path.exists(path):
        t0 = time.perf_counter()
        try:
            arrays = load_scene_arrays(path)
            arrays = arrays.with_transforms(scene.transforms())
            log.info(
                f"Scene cache hit: {path} "
                f"({(time.perf_counter() - t0) * 1e3:.1f} ms)"
            )
            return arrays
        except Exception as e:  # corrupt cache -> rebuild (graceful degradation)
            log.error(f"Scene cache load failed ({e}); rebuilding")
    t0 = time.perf_counter()
    host_arrays = pack_scene_host(scene, cfg)
    arrays = jax.device_put(host_arrays)  # one batched transfer
    try:
        # persist the numpy-leaved pack — no device readback
        save_scene_arrays(path, host_arrays)
        log.info(
            f"Scene cache written: {path} "
            f"(build {(time.perf_counter() - t0) * 1e3:.1f} ms)"
        )
    except Exception as e:
        log.error(f"Scene cache write failed: {e}")
    return arrays


# One fixed directory inside the checkout: the path is part of the cache's
# key, so a directory that moves with the working directory never hits.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".rayzen_cache", "xla",
)


def setup_compile_cache() -> str:
    """Persistent XLA compile cache (program-binary cache analog).

    Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and this
    sets nothing; otherwise the cache goes to DEFAULT_COMPILE_CACHE_DIR.
    Returns the directory in use."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(DEFAULT_COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    log.info(f"XLA compilation cache at {DEFAULT_COMPILE_CACHE_DIR}")
    return DEFAULT_COMPILE_CACHE_DIR
