"""CPU smoke coverage for the scripts and the chip-side entry points.

These tests run each script END TO END as a subprocess on the CPU backend
with tiny shapes, so a script cannot first crash on the chip for repo-side
reasons. They assert on the scripts' *output contracts* (files written,
lines printed, exit codes), not numbers — CPU timings mean nothing here.
The GPU-only entry points (chip_smoke.py, bench.py, walk_trial.py) must
refuse to run here: exit nonzero and print no result.
"""

import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(HERE, "scripts")


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _run(script, args=(), timeout=900, **envkw):
    return subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, script), *args],
        capture_output=True, text=True, cwd=HERE, timeout=timeout,
        env=_env(**envkw),
    )


class TestProgressiveSmoke:
    def test_end_to_end(self, tmp_path):
        out_md = str(tmp_path / "prog" / "PROGRESSIVE.md")
        os.makedirs(os.path.dirname(out_md), exist_ok=True)
        r = _run("progressive_1024.py", [out_md],
                 PROG_W="64", PROG_H="48", PROG_SPP="2", PROG_TOTAL="8")
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2000:])
        assert os.path.exists(out_md)
        body = open(out_md).read()
        assert "accumulated spp" in body and "| 8 |" in body
        assert "doubling-ratio" in r.stdout


class TestInteractiveScriptSmoke:
    def test_end_to_end(self, tmp_path):
        out_md = str(tmp_path / "isess" / "INTERACTIVE.md")
        os.makedirs(os.path.dirname(out_md), exist_ok=True)
        r = _run("interactive_1080p.py", timeout=1500,
                 ISESS_W="96", ISESS_H="64", ISESS_OUT=out_md,
                 ISESS_CACHE=str(tmp_path / "cache"))
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2000:])
        body = open(out_md).read()
        assert "PIPELINED session" in body
        assert "DEVICE-RATE pass" in body
        assert "| `click 960 540` |" in body  # full command mix ran
        png = os.path.join(os.path.dirname(out_md), "images",
                           "interactive_1080p.png")
        assert os.path.exists(png)


class TestBenchLargeSmoke:
    @pytest.mark.parametrize("mode,chunk", [("single", ""), ("chunked", "2000")])
    def test_end_to_end_tiny(self, tmp_path, mode, chunk):
        """bench_large.py at 4 instances / smoke resolution: scene synth,
        SSIM gate vs the XLA oracle, one tree or chunked trees, timing loop,
        final Mrays stdout contract."""
        r = subprocess.run(
            [sys.executable, os.path.join(SCRIPTS, "bench_large.py"),
             "4", mode, chunk, ""],
            capture_output=True, text=True, cwd=str(tmp_path), timeout=1200,
            env=_env(RAYZEN_LARGE_W="64", RAYZEN_LARGE_H="36",
                     RAYZEN_LARGE_SPP="1", RAYZEN_LARGE_GATE_W="64",
                     RAYZEN_LARGE_GATE_H="36", RAYZEN_LARGE_REPS="1"),
        )
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2000:])
        assert f"correctness gate [{mode}]" in r.stderr
        if mode == "chunked":
            assert "2 chunks of" in r.stderr
        # stdout contract: final line is the bare Mrays float
        float(r.stdout.strip().splitlines()[-1])


class TestGpuOnlyEntryPointsRefuseCpu:
    """A run that finds no GPU fails: no fallback, no replayed number."""

    def _run_root(self, script, cwd=HERE, args=()):
        return subprocess.run(
            [sys.executable, script, *args], capture_output=True, text=True,
            cwd=cwd, timeout=600, env=_env(),
        )

    def test_chip_smoke_fails_on_cpu(self):
        r = self._run_root(os.path.join(HERE, "chip_smoke.py"))
        assert r.returncode != 0, (r.stdout, r.stderr[-1500:])
        assert '"ok"' not in r.stdout
        assert "no GPU" in r.stderr

    def test_chip_smoke_fails_without_the_package(self, tmp_path):
        shutil.copy(os.path.join(HERE, "chip_smoke.py"), tmp_path)
        r = self._run_root(str(tmp_path / "chip_smoke.py"), cwd=str(tmp_path))
        assert r.returncode != 0, (r.stdout, r.stderr[-1500:])
        assert '"ok"' not in r.stdout

    def test_bench_fails_on_cpu(self):
        r = self._run_root(os.path.join(HERE, "bench.py"))
        assert r.returncode != 0, (r.stdout, r.stderr[-1500:])
        assert '"metric"' not in r.stdout
        assert "no GPU" in r.stderr

    def test_walk_trial_fails_on_cpu(self):
        r = self._run_root(os.path.join(SCRIPTS, "walk_trial.py"))
        assert r.returncode != 0, (r.stdout, r.stderr[-1500:])
        assert "Mrays/s" not in r.stdout
