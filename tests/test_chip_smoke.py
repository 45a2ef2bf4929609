"""chip_smoke.py rehearsed on the CPU at tiny sizes: every phase of the
one-device run and the four-device mesh run, through the same
functions the script calls on the card (the Pallas kernel in interpret
mode), and the refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = {
    "phase_flac": dict(n_streams=2, seconds=1.0, frames_per_group=4),
    # 95 frames: stream 0 reaches the asset's noise-substituted frames
    "phase_aac": dict(n_streams=2, seconds=2.2, frames_per_group=16),
    "phase_he": dict(n_streams=2, seconds=1.0, frames_per_group=8),
    "phase_mp3": dict(n_streams=2, nframes=20, frames_per_group=8),
    "phase_vorbis": dict(n_streams=2, nblocks=30, group=8),
    "phase_celt": dict(n_streams=2, n_packets=30, group=8),
    "phase_lpc": dict(rows=40, n=48, gpu_tests=False),
    "phase_renderer": dict(seconds=0.5, nframes=4, n=256),
}


def test_single_device_phases(capsys):
    rep = chip_smoke.Report("cpu rehearsal")
    chip_smoke.run_single(rep, TINY)
    out = capsys.readouterr().out
    assert rep.failed == [], out
    assert out.count(": ok (") == len(chip_smoke.PHASES) + 1


def test_multichip_phases(capsys):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs the 4-device CPU mesh")
    rep = chip_smoke.Report("cpu rehearsal")
    chip_smoke.run_multichip(rep, n_streams=4, seconds=1.0)
    out = capsys.readouterr().out
    assert rep.failed == [], out
    assert "lands as (64, 64) on each of 4 devices" in out


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr
