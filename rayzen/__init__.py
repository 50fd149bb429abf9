"""rayzen — a real-time path-tracing framework in JAX (XLA + Pallas), run on
NVIDIA GPUs.

A ground-up rebuild of the capabilities of the reference renderer PetoAdam/RayZen
(C++17 + OpenGL 4.3; see SURVEY.md) as an idiomatic JAX wavefront path tracer:
scene data as device-resident arrays, stackless BVH traversal (one Pallas walk
kernel per ray on the GPU) and GGX shading as dense masked device code, pixel
tiles sharded across devices with `shard_map`.
"""

from .camera import Camera  # noqa: F401
from .config import RenderConfig  # noqa: F401
from .light import Light  # noqa: F401
from .material import Material  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .scene import GameObject, Scene  # noqa: F401
from .packing import SceneArrays, WorldArrays, pack_scene, world_geometry  # noqa: F401
from .integrator import render_radiance, render_radiance_with_stats  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .deform import render_deforming, world_from_deforming  # noqa: F401
from .bigscene import partition_scene, render_radiance_chunked  # noqa: F401
from .interactive import InteractiveSession  # noqa: F401
from . import procedural  # noqa: F401

__version__ = "0.1.0"
