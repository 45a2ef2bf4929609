"""TestCodec-style matrix: every codec family streams a ~1 kHz tone
file through the FULL pipeline (file protocol -> container recognition
-> codec -> reservoirs -> animator) and the emitted waveform's
zero-crossing cadence is asserted.

This mirrors the reference's flagship codec test strategy
(Media/Codec/Tests/TestCodec.cpp:888-956: stream per-format tone files
through a minimal pipeline, count the 1 kHz sine's crossings;
per-format file list in TestCodecInit.cpp:23-89).  Lossless rows also
assert exact PCM; lossy rows assert cadence + codec identification.
"""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from test_pipeline_e2e import Collector, make_manager, run_until_halt, \
    zero_crossings

OR = pathlib.Path(__file__).resolve().parent.parent / ".oracle_build"


def _tone(freq, rate, seconds=1.0, amp=28000, channels=2):
    t = np.arange(int(rate * seconds)) / rate
    x = np.rint(np.sin(2 * np.pi * freq * t) * amp).astype(np.int32)
    return np.tile(x, (channels, 1))


def _play(path):
    mgr = make_manager()
    col = Collector()
    mgr.play_uri(f"file://{path}")
    run_until_halt(mgr, col)
    mgr.quit()
    return col


def _assert_cadence(pcm, rate, freq, tol_frac=0.02, tol_abs=8):
    n = pcm.shape[1]
    assert n > 0
    expected = 2.0 * freq * n / rate
    zc = zero_crossings(pcm[0])
    assert abs(zc - expected) <= tol_frac * expected + tol_abs, \
        (zc, expected)


# --- lossless rows: exact PCM and cadence --------------------------------

@pytest.mark.parametrize("rate,bits", [(44100, 16), (48000, 24)])
def test_matrix_wav(tmp_path, rate, bits):
    from ohpipeline_jax.codecs.wav import write_wav
    amp = 28000 if bits == 16 else 7_000_000
    tone = _tone(997, rate, amp=amp)
    p = tmp_path / "t.wav"
    p.write_bytes(write_wav(tone, rate, bits))
    col = _play(p)
    np.testing.assert_array_equal(col.pcm, tone)
    _assert_cadence(col.pcm, rate, 997)


def test_matrix_aiff(tmp_path):
    from ohpipeline_jax.codecs.aiff import write_aiff
    tone = _tone(997, 44100)
    p = tmp_path / "t.aiff"
    p.write_bytes(write_aiff(tone, 44100, 16))
    col = _play(p)
    np.testing.assert_array_equal(col.pcm, tone)
    assert col.infos[0].codec_name.startswith("AIFF")


@pytest.mark.parametrize("rate,bits", [(44100, 16), (48000, 24)])
def test_matrix_flac(tmp_path, rate, bits):
    from ohpipeline_jax.codecs import flac
    amp = 28000 if bits == 16 else 7_000_000
    tone = _tone(997, rate, amp=amp)
    p = tmp_path / "t.flac"
    p.write_bytes(flac.encode_flac(tone, rate, bits))
    col = _play(p)
    np.testing.assert_array_equal(col.pcm, tone)
    assert col.infos[0].codec_name == "FLAC"
    _assert_cadence(col.pcm, rate, 997)


# --- lossy rows: cadence + codec identification ---------------------------

def test_matrix_aac_adts(tmp_path):
    oracle = OR / "aac_oracle"
    if not oracle.exists():
        pytest.skip("aac oracle not built")
    tone = _tone(997, 44100, amp=20000)
    raw = tmp_path / "in.raw"
    out = tmp_path / "t.aac"
    np.ascontiguousarray(tone.T).astype(np.int16).tofile(raw)
    subprocess.run([str(oracle), "encode", str(raw), str(out), "44100",
                    "2", "128000"], check=True, capture_output=True)
    col = _play(out)
    assert "AAC" in col.infos[0].codec_name
    # the encoder prepends ~2 frames of priming; skip them for cadence
    pcm = col.pcm[:, 4096:]
    _assert_cadence(pcm, 44100, 997)


def test_matrix_mp3(tmp_path):
    from ohpipeline_jax.codecs.mp3 import encoder as ENC
    # one spectral line: f = (bin + 0.5) * rate / 1152
    data = ENC.build_stream([ENC.tone_spectrum(26)], nframes=40,
                            global_gain=180)
    p = tmp_path / "t.mp3"
    p.write_bytes(data)
    col = _play(p)
    assert col.infos[0].codec_name.startswith("MP3")
    f = 26.5 * 44100 / 1152
    _assert_cadence(col.pcm[:, 1152 * 2:], 44100, f, tol_frac=0.04)


def test_matrix_vorbis(tmp_path):
    from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
    spec = StreamSpec(channels=1, sample_rate=44100, bs0=256, bs1=1024)
    # one long-block residue bin: f = (k + 0.5) * rate / n
    k = 23
    blocks = []
    for _ in range(90):
        r = np.zeros((1, 512), np.int64)
        r[0, k] = 2
        blocks.append((1, [(200, 200)], r))
    p = tmp_path / "t.ogg"
    p.write_bytes(spec.build(blocks))
    col = _play(p)
    assert col.infos[0].codec_name == "Vorbis"
    f = (k + 0.5) * 44100 / 1024
    assert np.abs(col.pcm).max() > 500       # tone actually rendered
    _assert_cadence(col.pcm, 44100, f, tol_frac=0.04)


def test_matrix_opus(tmp_path):
    oracle = OR / "opus_oracle"
    if not oracle.exists():
        pytest.skip("opus oracle not built")
    tone = _tone(1000, 48000, amp=20000)
    raw = tmp_path / "in.raw"
    out = tmp_path / "t.opus"
    np.ascontiguousarray(tone.T).astype(np.int16).tofile(raw)
    subprocess.run([str(oracle), "encode", str(raw), str(out), "2",
                    "96000"], check=True, capture_output=True)
    col = _play(out)
    assert "Opus" in col.infos[0].codec_name
    # skip the codec's initial convergence region
    _assert_cadence(col.pcm[:, 2000:], 48000, 1000, tol_frac=0.03)
