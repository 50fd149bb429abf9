"""Test harness. Tests run on the CPU backend with 8 virtual devices, so
multi-device sharding is testable without accelerators (SURVEY.md §4),
unless JAX_PLATFORMS names another platform.

Tests that only a GPU can run carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them elsewhere; ``chip_smoke.py`` runs them on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
if ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402  (import after env is set)

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped elsewhere, run by chip_smoke.py"
    )


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def small_scene():
    from rayzen import demo

    return demo.build_small_scene(64, 48)


@pytest.fixture(scope="session")
def small_arrays(small_scene):
    from rayzen import pack_scene, RenderConfig

    return pack_scene(small_scene, RenderConfig(width=64, height=48))


@pytest.fixture(scope="session")
def small_camera(small_scene):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in small_scene.camera.device_params().items()}


def random_rays(n, seed=0, spread=2.0):
    rng = np.random.RandomState(seed)
    origins = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs
