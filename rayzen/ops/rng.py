"""Per-ray random number generation.

Two interchangeable samplers drive the integrator:

- ``ReferenceSampler`` reproduces the reference's sin-hash PRNG and its exact
  seeding flow (rand(): fragment_shader.glsl:188-190; per-sample seed :688;
  per-bounce tempseed :696; scatter/RR draw :720,:766; hemisphere draws :193-194;
  camera jitter :205) so images track the reference closely.
- ``HashSampler`` is the choice SURVEY.md §7 calls for: a counter-based
  integer hash keyed on (pixel, sample, bounce, dim) — well distributed,
  deterministic, stateless, and pure integer arithmetic (no transcendental-of-
  huge-argument like the sin hash).
"""

from __future__ import annotations

import jax.numpy as jnp


def ref_rand(uv: jnp.ndarray) -> jnp.ndarray:
    """fract(sin(dot(uv, (12.9898, 78.233))) * 43758.5453) over (..., 2) input."""
    d = uv[..., 0] * 12.9898 + uv[..., 1] * 78.233
    s = jnp.sin(d) * 43758.5453
    return s - jnp.floor(s)


class ReferenceSampler:
    """Stateful flow of the reference shader. ``pixel_uv`` is (R, 2) in [0, 1];
    ``frag`` is (R, 2) gl_FragCoord (pixel center + 0.5)."""

    def __init__(self, pixel_uv, frag):
        self.pixel_uv = pixel_uv
        self.frag = frag
        self.seed = None

    def start_sample(self, samp: int):
        # seed = uv * float(fragX + fragY + samp + 1.0)  (glsl:688)
        scale = self.frag[..., 0] + self.frag[..., 1] + (samp + 1.0)
        self.seed = self.pixel_uv * scale[..., None]

    def camera_jitter(self):
        # (glsl:205) jitter = (rand(seed), rand(seed + 1)) * 2e-5
        j0 = ref_rand(self.seed)
        j1 = ref_rand(self.seed + 1.0)
        return jnp.stack([j0, j1], axis=-1) * 0.00002

    def _tempseed(self, bounce):
        # (glsl:696); ``bounce`` may be a traced scalar (loop induction var)
        b = jnp.asarray(bounce, dtype=jnp.float32)
        return self.seed * (b * b) * 12793.46 + b * 1423.34

    def bounce_draws(self, samp: int, bounce):
        """Returns (rand_val, hemi_u, hemi_v); the reference reuses rand_val for
        both the reflect-vs-diffuse choice (:720) and Russian roulette (:766)."""
        ts = self._tempseed(bounce)
        b = jnp.asarray(bounce, dtype=jnp.float32)
        offs = jnp.stack([jnp.asarray(samp, jnp.float32), b])
        rand_val = ref_rand(ts + offs)
        hemi_u = ref_rand(ts)
        hemi_v = ref_rand(ts + 1.0)
        return rand_val, hemi_u, hemi_v


def _hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """lowbias32 integer hash (Chris Wellons' prospecting constants)."""
    x = x.astype(jnp.uint32)
    x ^= x >> 16
    x *= jnp.uint32(0x7FEB352D)
    x ^= x >> 15
    x *= jnp.uint32(0x846CA68B)
    x ^= x >> 16
    return x


def _u32_to_unit_float(x: jnp.ndarray) -> jnp.ndarray:
    # top 24 bits -> [0, 1)
    return (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


class HashSampler:
    """Counter-based sampler: value = hash(pixel_id, key, sample, bounce, dim)."""

    # dimension tags
    JITTER_X, JITTER_Y, SCATTER, HEMI_U, HEMI_V = 0, 1, 2, 3, 4

    def __init__(self, pixel_id, key: int = 0):
        self.pixel_id = pixel_id.astype(jnp.uint32)
        self.key = jnp.uint32(key)
        self._samp = 0

    def start_sample(self, samp: int):
        self._samp = samp

    def _draw(self, bounce, dim: int):
        # ``bounce`` may be a traced scalar
        b = jnp.asarray(bounce).astype(jnp.uint32)
        h = _hash_u32(self.pixel_id ^ _hash_u32(self.key + jnp.uint32(0x9E3779B9)))
        h = _hash_u32(h + jnp.uint32(self._samp * 7919) + b * jnp.uint32(127) + jnp.uint32(dim))
        return _u32_to_unit_float(h)

    def camera_jitter(self):
        jx = self._draw(0, self.JITTER_X) - 0.5
        jy = self._draw(0, self.JITTER_Y) - 0.5
        return jnp.stack([jx, jy], axis=-1)  # full-pixel AA jitter

    def bounce_draws(self, samp: int, bounce: int):
        return (
            self._draw(bounce, self.SCATTER),
            self._draw(bounce, self.HEMI_U),
            self._draw(bounce, self.HEMI_V),
        )
