"""Whole-app integration: run tools/player.py as a subprocess (the
reference's TestMediaPlayer role) against real files of three codec
families and verify the rendered WAV."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PLAYER = ROOT / "tools" / "player.py"
PYGAME_DATA = pathlib.Path(
    "/opt/venv/lib/python3.12/site-packages/pygame/examples/data")


def run_player(uri: str, out: pathlib.Path) -> str:
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run(
        [sys.executable, str(PLAYER), "--uri", uri, "--wav", str(out)],
        capture_output=True, timeout=1200, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout.decode()


def read_wav(path: pathlib.Path) -> np.ndarray:
    from ohpipeline_jax.codecs.wav import parse_wav
    info, pcm = parse_wav(path.read_bytes())
    return pcm


def test_tone_uri(tmp_path):
    out = tmp_path / "o.wav"
    log = run_player("tone://sine.wav?pitch=997&duration=1", out)
    assert "rendered" in log
    pcm = read_wav(out)
    assert pcm.shape[1] >= 44100 // 2
    x = pcm[0].astype(np.float64)
    zc = np.sum(np.abs(np.diff(np.sign(x[2000:30000]))) > 1) / 2
    f = zc / (28000 / 44100)
    assert 900 < f < 1100, f


@pytest.mark.skipif(not (PYGAME_DATA / "house_lo.ogg").exists(),
                    reason="no real vector")
def test_real_vorbis_file(tmp_path):
    out = tmp_path / "o.wav"
    run_player(f"file://{PYGAME_DATA}/house_lo.ogg", out)
    pcm = read_wav(out)
    assert pcm.shape[1] > 70000 and np.abs(pcm).max() > 2000


@pytest.mark.skipif(not (PYGAME_DATA / "house_lo.mp3").exists(),
                    reason="no real vector")
def test_real_mp3_file(tmp_path):
    out = tmp_path / "o.wav"
    run_player(f"file://{PYGAME_DATA}/house_lo.mp3", out)
    pcm = read_wav(out)
    assert pcm.shape[1] > 70000 and np.abs(pcm).max() > 2000
