"""CELT frame-decoder conformance vs the reference decoder
(tools/celt_probe.c `celtdec`), across frame sizes, channel counts,
bitrates, and content types."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax.codecs.opus.celt import CeltDecoderState, decode_frame

PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "celt_probe")

pytestmark = pytest.mark.skipif(not os.path.exists(PROBE),
                                reason="celt_probe not built")


def _content(kind: str, n: int, rate=48000, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    if kind == "tone":
        x = 0.5 * np.sin(2 * np.pi * 440 * t) \
            + 0.1 * rng.standard_normal(n)
    elif kind == "noise":
        x = 0.3 * rng.standard_normal(n)
    elif kind == "transient":
        x = 0.2 * np.sin(2 * np.pi * 700 * t)
        for s in rng.integers(0, n - 500, 12):
            x[s:s + 300] += 0.7 * np.sign(np.sin(2 * np.pi * 50
                                                 * t[:300]))
    else:  # quiet
        x = 0.01 * np.sin(2 * np.pi * 200 * t)
    return x


def _run(channels, frame, bitrate, kind, seed=1, nframes=25):
    n = frame * nframes
    x = _content(kind, n, seed=seed)
    if channels == 2:
        pcm = np.stack([x, np.roll(x, 7)])
    else:
        pcm = x[None, :]
    pcm16 = np.clip(np.rint(pcm * 20000), -32768, 32767).astype(np.int16)
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "in.raw")
        fr = os.path.join(td, "f.bin")
        np.ascontiguousarray(pcm16.T).tofile(raw)
        subprocess.run([PROBE, "celtenc", raw, fr, str(channels),
                        str(frame), str(bitrate)], check=True)
        ref = np.frombuffer(subprocess.run(
            [PROBE, "celtdec", fr, str(channels), str(frame)],
            capture_output=True, check=True).stdout, np.float32) \
            .reshape(-1, channels).T
        st = CeltDecoderState(channels)
        data = open(fr, "rb").read()
    outs = []
    pos = 0
    while pos + 2 <= len(data):
        ln = data[pos] | data[pos + 1] << 8
        pos += 2
        outs.append(decode_frame(st, data[pos:pos + ln], frame))
        pos += ln
    got = np.concatenate(outs, axis=1)
    m = min(got.shape[1], ref.shape[1])
    return float(np.abs(got[:, :m] - ref[:, :m]).max())


# conformance bound: well under 1 int16 LSB (1/32768 ~ 3e-5)
TOL = 1e-5


@pytest.mark.parametrize("frame", [120, 240, 480, 960])
def test_frame_sizes_stereo(frame):
    assert _run(2, frame, 128000, "tone") < TOL


@pytest.mark.parametrize("kind", ["tone", "noise", "transient", "quiet"])
def test_content_types(kind):
    assert _run(2, 960, 96000, kind, seed=3) < TOL


@pytest.mark.parametrize("bitrate", [24000, 48000, 64000, 256000])
def test_bitrates(bitrate):
    # low rates exercise folding/noise-fill/skip; high rates deep splits
    assert _run(2, 960, bitrate, "transient", seed=5) < TOL


@pytest.mark.parametrize("frame", [120, 960])
def test_mono(frame):
    assert _run(1, frame, 64000, "tone", seed=7) < TOL


def test_mono_low_rate_noise():
    assert _run(1, 480, 16000, "noise", seed=9) < TOL
