"""Runtime-layer tests: Renderer frame loop, caches, overlays, image IO, CLI,
profiler, RNG samplers."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from rayzen.cache import (
    cached_pack_scene,
    load_scene_arrays,
    save_scene_arrays,
)
from rayzen.config import RenderConfig
from rayzen.demo import build_small_scene
from rayzen.image_io import read_ppm, ssim, to_uint8, write_png, write_ppm
from rayzen.ops import rng as rng_mod
from rayzen.overlay import apply_overlays, blas_branch_boxes, hsv2rgb
from rayzen.packing import pack_scene
from rayzen.preview import render_preview
from rayzen.profiler import FrameProfiler
from rayzen.renderer import Renderer


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("cache"))
    return RenderConfig(
        width=32, height=24, spp=1, max_bounces=2, cache_dir=cache
    )


@pytest.fixture(scope="module")
def renderer(tiny_cfg):
    scene = build_small_scene(tiny_cfg.width, tiny_cfg.height)
    return Renderer(scene, tiny_cfg, async_compile=False)


class TestRenderer:
    def test_first_frame_uses_reduced_bounces(self, renderer):
        # frame 0 budget = 1 bounce (main.cpp:600); frames differ
        f0 = renderer.render_frame()
        f1 = renderer.render_frame()
        assert f0.shape == f1.shape == (24, 32, 3)
        assert np.abs(f0 - f1).max() > 1e-4

    def test_preview_mode(self, renderer):
        p = renderer.render_frame(mode="preview")
        assert p.shape == (24, 32, 3)
        assert np.isfinite(p).all()

    def test_dynamic_transforms_change_image(self, renderer):
        before = renderer.render_frame()
        t = np.asarray(renderer.arrays.transforms).copy()
        t[1] = t[1].copy()
        t[1][0, 3] += 1.0
        renderer.update_transforms(t)
        after = renderer.render_frame()
        assert np.abs(after - before).max() > 1e-3

    def test_profiler_records(self, renderer):
        renderer.render_frame()
        rec = renderer.profiler.history[-1]
        assert "render" in rec and rec["total"] > 0

    def test_accumulation(self, tiny_cfg):
        cfg = tiny_cfg.replace(accumulate=True, spp=1)
        scene = build_small_scene(cfg.width, cfg.height)
        r = Renderer(scene, cfg, async_compile=False, use_cache=False)
        r.render_frame()
        a1 = r.render_frame()
        a2 = r.render_frame()
        assert r._accum_count >= 2
        assert np.isfinite(a2).all()
        # accumulation converges: successive frames get closer
        assert np.abs(a2 - a1).mean() < 0.2

    def test_progressive_variance_decays(self, tiny_cfg):
        """BASELINE config 4 in miniature (scripts/progressive_1024.py runs
        the full 1024-spp version on device): the progressive average's MSE
        against an independent high-spp target must decay ~1/n — monotone
        across checkpoint frames with a real margin, not just wiggle."""
        cfg = tiny_cfg.replace(accumulate=True, spp=4, max_bounces=3)
        scene = build_small_scene(cfg.width, cfg.height)
        r = Renderer(scene, cfg, async_compile=False, use_cache=False)
        # independent target: same scene at higher spp on a disjoint key
        # stream (rng_key offsets the sample index far past the accum frames)
        tgt_cfg = cfg.replace(accumulate=False, spp=32)
        from rayzen.integrator import render_radiance

        import jax
        import jax.numpy as jnp

        target = np.asarray(
            jax.jit(
                lambda a, c: render_radiance(a, c, tgt_cfg, rng_key=99)
            )(r.arrays, r._camera_params())
        ).reshape(cfg.height, cfg.width, 3)
        errs = []
        for _ in range(8):
            img = r.render_frame(mode="pt")
            # L1, not MSE: Monte-Carlo error is heavy-tailed (mirror/RR
            # fireflies), so per-realization MSE is not monotone — a single
            # bright sample in a late frame can raise it. Mean |error| is
            # robust to that while still decaying with sample count.
            errs.append(float(np.mean(np.abs(img - target))))
        assert errs[3] < errs[0] / 1.2, errs
        assert errs[7] < errs[0] / 1.5, errs


class TestCache:
    def test_roundtrip(self, tiny_cfg):
        scene = build_small_scene(32, 24)
        arrays = pack_scene(scene, tiny_cfg)
        path = os.path.join(tiny_cfg.cache_dir, "roundtrip.npz")
        save_scene_arrays(path, arrays)
        back = load_scene_arrays(path)
        assert back.instance_meta == arrays.instance_meta
        np.testing.assert_array_equal(
            np.asarray(back.tri_v0), np.asarray(arrays.tri_v0)
        )
        np.testing.assert_array_equal(
            np.asarray(back.node_meta), np.asarray(arrays.node_meta)
        )

    def test_cached_pack_hit_refreshes_transforms(self, tiny_cfg):
        scene = build_small_scene(32, 24)
        a1 = cached_pack_scene(scene, tiny_cfg)
        # mutate a transform, re-pack from cache: must reflect the new transform
        scene.game_objects[1].transform = scene.game_objects[1].transform.copy()
        scene.game_objects[1].transform[1, 3] += 2.0
        a2 = cached_pack_scene(scene, tiny_cfg)
        assert not np.allclose(
            np.asarray(a1.transforms[1]), np.asarray(a2.transforms[1])
        )
        np.testing.assert_array_equal(
            np.asarray(a1.tri_v0), np.asarray(a2.tri_v0)
        )

    def test_force_rebuild(self, tiny_cfg):
        scene = build_small_scene(32, 24)
        a = cached_pack_scene(scene, tiny_cfg, force_rebuild=True)
        assert a.num_instances == 4

    def test_per_mesh_blas_disk_cache(self, tiny_cfg, monkeypatch):
        """A second scene sharing a mesh skips its BLAS build via the content-
        hashed disk cache (reference bvh_cache/v2 analog, main.cpp:951-969 —
        but keyed by mesh content so it survives across scenes/processes)."""
        import rayzen.packing as packing_mod

        scene = build_small_scene(32, 24)
        packing_mod._blas_cache.clear()
        pack_scene(scene, tiny_cfg)  # builds + writes the disk tier
        # fresh process simulation: empty memo, builders must NOT run
        packing_mod._blas_cache.clear()

        def boom(*a, **k):
            raise AssertionError("BLAS builder ran despite a disk-cache hit")

        monkeypatch.setattr(packing_mod, "build_blas", boom)
        monkeypatch.setattr(
            packing_mod.native, "build_blas", boom, raising=False
        )
        a2 = pack_scene(scene, tiny_cfg)
        assert a2.num_instances == 4
        # rebuild_bvh bypasses the disk tier (reference --rebuild-bvh parity)
        packing_mod._blas_cache.clear()
        with pytest.raises(AssertionError):
            pack_scene(scene, tiny_cfg.replace(rebuild_bvh=True))


class TestOverlays:
    def test_hsv2rgb(self):
        assert np.allclose(hsv2rgb(0.0, 1.0, 1.0), [1, 0, 0], atol=1e-6)
        assert np.allclose(hsv2rgb(1 / 3, 1.0, 1.0), [0, 1, 0], atol=1e-6)
        assert np.allclose(hsv2rgb(0.5, 0.0, 0.7), [0.7, 0.7, 0.7], atol=1e-6)

    def test_overlays_change_pixels(self, tiny_cfg, renderer):
        img = jnp.zeros((24, 32, 3), jnp.float32) + 0.5
        cam = renderer._camera_params()
        cfg = tiny_cfg.replace(
            debug_show_bvh=True, debug_show_lights=True, show_fps_overlay=True
        )
        out = np.asarray(apply_overlays(img, renderer.arrays, cam, cfg, fps=42.5))
        assert out.shape == (24, 32, 3)
        assert np.abs(out - 0.5).max() > 0.05

    @pytest.mark.parametrize("mode,sel", [(0, (0, 0)), (1, (1, 3))])
    def test_composite_core_matches_eager(self, tiny_cfg, renderer, mode, sel):
        """The single-dispatch jitted composite (the frame loop's overlay
        path) must produce the same frame as the eager apply_overlays
        reference, in both BVH modes (padded branch boxes included)."""
        img = jnp.zeros((24, 32, 3), jnp.float32) + 0.25
        cam = renderer._camera_params()
        cfg = tiny_cfg.replace(
            debug_show_bvh=True, debug_bvh_mode=mode,
            debug_selected_blas=sel[0], debug_selected_tri=sel[1],
            debug_show_lights=True, show_fps_overlay=True,
        )
        eager = np.asarray(
            apply_overlays(img, renderer.arrays, cam, cfg, fps=7.3))
        renderer.cfg = cfg
        renderer.profiler.fps_ema = 7.3
        jitted = np.asarray(renderer._composite_overlays(img, cam))
        np.testing.assert_allclose(jitted, eager, atol=2e-6)

    def test_composite_overlay_cache_invalidates_on_update(self, renderer):
        """Scene updates replace renderer.arrays; the box-input cache must
        rebuild (identity check), not serve the old transforms' boxes."""
        img = jnp.zeros((24, 32, 3), jnp.float32)
        cam = renderer._camera_params()
        renderer.cfg = renderer.cfg.replace(
            debug_show_bvh=True, debug_show_lights=False,
            show_fps_overlay=False)
        a = np.asarray(renderer._composite_overlays(img, cam))
        xf = np.asarray(renderer.arrays.transforms).copy()
        xf[:, 0, 3] += 0.7  # translate every instance in x
        renderer.arrays = renderer.arrays.with_transforms(jnp.asarray(xf))
        b = np.asarray(renderer._composite_overlays(img, cam))
        assert np.abs(a - b).max() > 1e-3

    def test_branch_boxes_path(self, renderer):
        boxes, colors = blas_branch_boxes(renderer.arrays, 1, 0)
        assert len(boxes) >= 1
        assert len(boxes) == len(colors)
        # root box must be first and largest
        assert boxes[0].shape == (8, 3)

    def test_branch_boxes_out_of_range(self, renderer):
        boxes, colors = blas_branch_boxes(renderer.arrays, 1, 10**6)
        assert boxes == []


class TestImageIO:
    def test_png_write(self, tmp_path):
        img = np.random.RandomState(0).uniform(0, 1, (16, 20, 3)).astype(np.float32)
        p = str(tmp_path / "x.png")
        write_png(p, img)
        with open(p, "rb") as f:
            magic = f.read(8)
        assert magic == b"\x89PNG\r\n\x1a\n"

    def test_ppm_roundtrip(self, tmp_path):
        img = np.random.RandomState(1).uniform(0, 1, (8, 10, 3)).astype(np.float32)
        p = str(tmp_path / "x.ppm")
        write_ppm(p, img)
        back = read_ppm(p)
        assert back.shape == (8, 10, 3)
        np.testing.assert_array_equal(back[::-1], to_uint8(img))

    def test_ssim_identity_and_noise(self):
        rng = np.random.RandomState(2)
        a = rng.uniform(0, 1, (64, 64, 3))
        assert ssim(a, a) > 0.999
        b = np.clip(a + rng.normal(0, 0.25, a.shape), 0, 1)
        assert ssim(a, b) < 0.9


class TestRng:
    def test_ref_rand_range_and_determinism(self):
        uv = jnp.asarray(
            np.random.RandomState(0).uniform(0, 2000, (512, 2)).astype(np.float32)
        )
        r1 = np.asarray(rng_mod.ref_rand(uv))
        r2 = np.asarray(rng_mod.ref_rand(uv))
        assert (r1 == r2).all()
        assert (r1 >= 0).all() and (r1 < 1).all()

    def test_hash_sampler_distribution(self):
        pid = jnp.arange(4096, dtype=jnp.uint32)
        s = rng_mod.HashSampler(pid, key=3)
        s.start_sample(0)
        vals = np.asarray(s.bounce_draws(0, 1)[0])
        assert (vals >= 0).all() and (vals < 1).all()
        assert abs(vals.mean() - 0.5) < 0.02
        # different bounces decorrelated
        v2 = np.asarray(s.bounce_draws(0, 2)[0])
        assert abs(np.corrcoef(vals, v2)[0, 1]) < 0.05


class TestProfiler:
    def test_phases_and_ema(self):
        p = FrameProfiler(fps_alpha=0.5)
        for _ in range(3):
            p.begin_frame()
            with p.phase("work"):
                pass
            p.end_frame(rays_traced=1000)
        assert p.frame_index == 3
        assert p.fps_ema is not None and p.fps_ema > 0
        s = p.summary(skip=1)
        assert "work" in s and "mrays_per_s" in s

    def test_async_record_does_not_inherit_sync_phases(self):
        """ADVICE r4: record() without phases (the PendingFrame.resolve async
        path) must not carry the previous sync frame's phase timings."""
        p = FrameProfiler()
        p.begin_frame()
        with p.phase("render"):
            pass
        p.end_frame()
        rec = p.record(12.5)  # externally-timed async frame
        assert "render" not in rec
        assert rec["total"] == 12.5

    def test_pipelined_fps_reflects_arrival_rate(self):
        """ADVICE r4: with N frames in flight each resolve reports ~N-frame
        latency; fps must come from the inter-resolve interval, not the
        latency, or the pipelined rate is understated ~N-fold."""
        import time as _time

        p = FrameProfiler(fps_alpha=1.0)  # EMA == last frame
        p.record(300.0)  # first: latency-derived (no prior interval)
        assert p.fps_ema == pytest.approx(1000.0 / 300.0, rel=1e-6)
        _time.sleep(0.02)
        p.record(300.0)  # resolves ~20 ms apart at ~300 ms latency
        assert p.fps_ema > 20.0  # ~50 fps arrival, NOT ~3.3 fps latency
        # a synchronous slow frame (interval >= latency) stays latency-derived
        _time.sleep(0.05)
        p.record(40.0)
        assert p.fps_ema == pytest.approx(25.0, rel=0.05)


class TestCli:
    def test_cli_smoke(self, tmp_path, monkeypatch):
        from rayzen.cli import main

        out = str(tmp_path / "o.png")
        rc = main(
            [
                "--width", "32", "--height", "24", "--bounces", "2",
                "--frames", "1", "--out", out, "--path-tracer-only",
                "--log", "error", "--cache-dir", str(tmp_path / "cache"),
            ]
        )
        assert rc == 0
        assert os.path.exists(out)

    def test_cli_preview(self, tmp_path):
        from rayzen.cli import main

        out = str(tmp_path / "p.png")
        rc = main(
            [
                "--width", "32", "--height", "24", "--preview", "--frames", "1",
                "--out", out, "--log", "error",
                "--cache-dir", str(tmp_path / "cache"),
            ]
        )
        assert rc == 0
        assert os.path.exists(out)


class TestCompileFailure:
    def test_compile_failure_falls_back_to_preview(self, tiny_cfg, monkeypatch):
        # a failing path-tracer compile must not deadlock warmup/__init__
        # (reference analog: editor-mode fallback, main.cpp:425-429)
        import rayzen.renderer as renderer_mod

        def boom(*a, **k):
            raise RuntimeError("injected compile failure")

        monkeypatch.setattr(renderer_mod, "render_radiance_with_stats", boom)
        scene = build_small_scene(tiny_cfg.width, tiny_cfg.height)
        cfg = tiny_cfg.replace(warmup_frames=1)
        r = Renderer(scene, cfg, async_compile=True, use_cache=False)
        assert r.path_tracer_failed
        assert not r.path_tracer_ready
        img = r.render_frame()  # auto mode serves the preview
        assert img.shape == (cfg.height, cfg.width, 3)
        assert np.isfinite(img).all()
        r.close()


    def test_path_tracer_only_raises(self, tiny_cfg, monkeypatch):
        # with no preview to fall back to, a failed compile is an error
        import rayzen.renderer as renderer_mod

        def boom(*a, **k):
            raise RuntimeError("injected compile failure")

        monkeypatch.setattr(renderer_mod, "render_radiance_with_stats", boom)
        scene = build_small_scene(tiny_cfg.width, tiny_cfg.height)
        with pytest.raises(RuntimeError, match="compile failed"):
            Renderer(scene, tiny_cfg.replace(path_tracer_only=True),
                     use_cache=False)

    def test_offscreen_cli_exits_nonzero(self, tmp_path, monkeypatch):
        # an offscreen render must not hand in a preview image and exit 0
        import rayzen.renderer as renderer_mod
        from rayzen.cli import main

        def boom(*a, **k):
            raise RuntimeError("injected compile failure")

        monkeypatch.setattr(renderer_mod, "render_radiance_with_stats", boom)
        out = str(tmp_path / "o.png")
        rc = main(["--width", "32", "--height", "24", "--bounces", "2",
                   "--out", out, "--log", "error",
                   "--cache-dir", str(tmp_path / "cache")])
        assert rc == 1
        assert not os.path.exists(out)


class TestCompileCache:
    def test_env_dir_is_left_to_jax(self, monkeypatch, tmp_path):
        import jax

        from rayzen import cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_dir_inside_the_checkout(self, monkeypatch):
        import jax

        from rayzen import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(repo, ".rayzen_cache", "xla")
        assert cache.DEFAULT_COMPILE_CACHE_DIR == want
        assert cache.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)


    def test_cli_run_writes_cache_where_env_says(self, tmp_path):
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR=str(tmp_path / "xla"),
                   PYTHONPATH=repo)
        r = subprocess.run(
            [sys.executable, "-m", "rayzen", "--width", "16", "--height",
             "12", "--bounces", "2", "--out", str(tmp_path / "f.png"),
             "--log", "info", "--path-tracer-only",
             "--cache-dir", str(tmp_path / "scene")],
            capture_output=True, text=True, cwd=str(tmp_path), env=env,
            timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert os.listdir(tmp_path / "xla"), "no compiled program cached"
        assert "XLA compilation cache at" not in r.stdout + r.stderr


class TestAccumulateFrameZero:
    def test_frame0_uses_full_bounces(self, tiny_cfg):
        # frame 0 must not seed the accumulator with the reduced-bounce render
        cfg = tiny_cfg.replace(accumulate=True, spp=1)
        scene = build_small_scene(cfg.width, cfg.height)
        r = Renderer(scene, cfg, async_compile=False, use_cache=False)
        f0 = r.render_frame()
        # reference image: the full-bounce render with the same rng key (0)
        full, _ = r._render_full(r.arrays, r._camera_params(), jnp.uint32(0))
        np.testing.assert_allclose(f0, np.asarray(full), atol=1e-6)
