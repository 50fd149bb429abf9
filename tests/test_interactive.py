"""Recorded interactive sessions: keystrokes mutate camera/toggles between
frames without restarts (VERDICT r1 #5; reference main.cpp:441-552, 690-740)."""

import io
import os

import numpy as np
import pytest

from rayzen.config import RenderConfig
from rayzen.demo import build_small_scene
from rayzen.interactive import InteractiveSession
from rayzen.renderer import Renderer


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("live")
    cfg = RenderConfig(
        width=48, height=32, spp=1, max_bounces=2,
        cache_dir=str(tmp / "cache"),
    )
    scene = build_small_scene(48, 32)
    r = Renderer(scene, cfg, async_compile=False)
    return InteractiveSession(
        r, out_path=str(tmp / "live.png"), status=io.StringIO()
    ), tmp


class TestRecordedSession:
    def test_movement_changes_frame(self, session):
        s, tmp = session
        s.run(io.StringIO("w 0.4\n"))
        first = s.frame.copy()
        assert os.path.exists(str(tmp / "live.png"))
        s.handle("look 40 0")
        assert not np.allclose(first, s.frame)  # camera moved the image
        pos0 = s.r.scene.camera.position.copy()
        s.handle("d 0.5")
        assert not np.allclose(pos0, s.r.scene.camera.position)

    def test_toggles_flip_config_live(self, session):
        s, _ = session
        assert not s.r.cfg.debug_show_bvh
        s.handle("b")
        assert s.r.cfg.debug_show_bvh
        s.handle("l")
        assert s.r.cfg.debug_show_lights
        s.handle("n")
        assert s.r.cfg.debug_bvh_mode == 1
        s.handle("b")
        s.handle("l")
        assert not (s.r.cfg.debug_show_bvh or s.r.cfg.debug_show_lights)
        s.handle("n")

    def test_preview_toggle_and_quit(self, session):
        s, _ = session
        s.handle("p")
        assert s.mode == "preview"
        s.handle("p")
        assert s.mode == "auto"
        assert s.handle("quit") is False

    def test_click_selects_triangle(self, session):
        s, _ = session
        out = s.status
        s.handle("click 24 10")  # center-ish: the demo floor/objects
        text = out.getvalue()
        assert "pick:" in text

    def test_save(self, session):
        s, tmp = session
        s.handle(f"save {tmp / 'snap.png'}")
        assert os.path.exists(str(tmp / "snap.png"))


class TestPipelinedSession:
    """run(pipeline=N) keeps frames in flight (VERDICT r3 #7): same frames,
    same final state as the synchronous loop — only the sync points move."""

    def test_pipeline_matches_sync(self, tmp_path):
        cfg = RenderConfig(
            width=48, height=32, spp=1, max_bounces=2,
            cache_dir=str(tmp_path / "cache"),
        )
        cmds = ["w 0.4", "look 30 0", "d 0.3", "b", "w 0.2"]

        scene_a = build_small_scene(48, 32)
        ra = Renderer(scene_a, cfg, use_cache=False, async_compile=False)
        sa = InteractiveSession(ra, out_path=None, status=io.StringIO())
        n_sync = sa.run(iter(cmds + ["quit"]))

        scene_b = build_small_scene(48, 32)
        rb = Renderer(scene_b, cfg, use_cache=False, async_compile=False)
        sb = InteractiveSession(rb, out_path=None, status=io.StringIO())
        n_pipe = sb.run(iter(cmds + ["quit"]), pipeline=3)

        assert n_pipe == n_sync
        # all in-flight frames resolved at session end
        assert not sb._pending
        # same camera trajectory and same final frame
        np.testing.assert_allclose(
            sa.r.scene.camera.position, sb.r.scene.camera.position
        )
        np.testing.assert_allclose(sa.frame, sb.frame, atol=1e-6)
        # every dispatched frame produced a status line
        assert sb.status.getvalue().count("frame ") == n_pipe

    def test_save_drains_inflight_frames(self, tmp_path):
        cfg = RenderConfig(
            width=48, height=32, spp=1, max_bounces=2,
            cache_dir=str(tmp_path / "cache"),
        )
        scene = build_small_scene(48, 32)
        r = Renderer(scene, cfg, use_cache=False, async_compile=False)
        s = InteractiveSession(r, out_path=None, status=io.StringIO())
        snap = tmp_path / "snap.png"
        # save arrives while 3 frames are still in flight: it must resolve
        # them first so the written PNG reflects the latest command
        s.run(iter(["w 0.4", "look 20 0", "w 0.2", f"save {snap}", "quit"]),
              pipeline=4)
        assert os.path.exists(str(snap))
        assert not s._pending


class TestBatchedFlythrough:
    """render_batch: K scripted frames in one dispatch (lax.scan over stacked
    camera params) must produce exactly the sync loop's frames — same overlay
    state, same key — and count the same rays. The batch is the scanout
    analog for motion known ahead of time."""

    def test_batch_matches_sync_loop(self, tmp_path):
        from rayzen.renderer import stack_camera_params

        cfg = RenderConfig(
            width=48, height=32, spp=1, max_bounces=2,
            show_fps_overlay=True, debug_show_lights=True,
            cache_dir=str(tmp_path / "cache"),
        )
        moves = ["w 0.4", "look 30 0", "d 0.3", "look -20 5"]

        # sync loop: apply each move, render a frame, remember cams + rays
        scene_a = build_small_scene(48, 32)
        ra = Renderer(scene_a, cfg, use_cache=False, async_compile=False)
        sa = InteractiveSession(ra, out_path=None, status=io.StringIO())
        sa.run(iter([]))  # frame 0 so the batch never hits first-frame mode
        cams, sync_frames, sync_rays = [], [], []
        fps_pin = ra.profiler.fps_ema or 0.0
        for mv in moves:
            sa._apply(mv)
            cam = {k: np.asarray(v) for k, v in
                   ra.scene.camera.device_params().items()}
            cams.append(cam)
            # pin the fps overlay value so sync and batch draw the same text
            ra.profiler.fps_ema = fps_pin
            sync_frames.append(ra.render_frame())
            # exact per-frame ray count from the same program the scan calls
            import jax.numpy as jnp

            _, rays_f = ra._render_full(
                ra._trace_arrays,
                {k: jnp.asarray(v) for k, v in cam.items()},
                jnp.uint32(0),
            )
            sync_rays.append(int(rays_f))

        # batch: same renderer type, same camera trajectory, one dispatch
        scene_b = build_small_scene(48, 32)
        rb = Renderer(scene_b, cfg, use_cache=False, async_compile=False)
        rb.warmup(1)
        img, rays = rb.render_batch(stack_camera_params(cams), fps=fps_pin)
        np.testing.assert_allclose(
            np.asarray(img), sync_frames[-1], atol=1e-6
        )
        assert int(rays) == sum(sync_rays)
        assert rb.frame_index == len(moves)  # the batch advanced the counter

    def test_batch_guards(self, tmp_path):
        cfg = RenderConfig(
            width=48, height=32, spp=1, max_bounces=2, accumulate=True,
            cache_dir=str(tmp_path / "cache"),
        )
        scene = build_small_scene(48, 32)
        r = Renderer(scene, cfg, use_cache=False, async_compile=False)
        with pytest.raises(RuntimeError):
            r.render_batch(
                {k: np.asarray(v)[None]
                 for k, v in scene.camera.device_params().items()}
            )
