"""Multi-stream batched device MP3 decode (codecs/mp3/serving.py) vs
the host decode_mp3 path (itself sample-exact vs the libmad oracle).
The int16 spectrum wire costs ~3e-5 granule-relative error, so the
bound is 6 LSB of int16 output / 80 dB SNR (measured 4-5 LSB, ~90 dB;
same rationale as the Vorbis device-path bounds in
test_vorbis_device.py)."""

import numpy as np

from ohpipeline_jax.codecs.mp3 import decode_mp3, encoder as ENC
from ohpipeline_jax.codecs.mp3.serving import decode_mp3_streams_device


def _stream(seed: int, nframes: int) -> bytes:
    """Varied stereo MP3: per-frame random sparse spectra and gains so
    no two frames (or streams) requantize identically."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(nframes):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.22
        spec[m] = rng.integers(1, 12, m.sum())
        spec[rng.random((2, 576)) < 0.5] *= -1
        frames.append(ENC.build_frame(
            [spec[0], spec[1]],
            global_gain=int(rng.integers(172, 186))))
    return b"".join(frames)


def test_streams_device_matches_host():
    streams = [_stream(i, 12 + 7 * i) for i in range(3)]  # ragged lengths
    refs = [decode_mp3(s)[1] for s in streams]
    outs = decode_mp3_streams_device(streams, frames_per_group=8)
    assert len(outs) == 3
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        d = np.abs(got.astype(np.float64) - ref)
        # int16 spectrum wire: ~3e-5 granule-relative error accumulates
        # through the 576-point IMDCT to a few LSB peak (measured 4-5,
        # ~90 dB SNR) — same 6-LSB stance as test_vorbis_device.py
        assert d.max() <= 6.0, d.max()
        err = got.astype(np.float64) - ref
        p = float((ref.astype(np.float64) ** 2).mean())
        if p > 0:
            snr = 10 * np.log10(p / max((err ** 2).mean(), 1e-30))
            assert snr >= 80.0, snr


def test_single_stream_group_boundaries():
    data = _stream(9, 21)
    ref = decode_mp3(data)[1]
    for g in (4, 16):
        out = decode_mp3_streams_device([data], frames_per_group=g)[0]
        assert out.shape == ref.shape
        d = np.abs(out.astype(np.float64) - ref)
        assert d.max() <= 6.0, (g, d.max())


def test_mismatched_batch_rejected():
    import pytest
    a = _stream(1, 6)
    mono = ENC.build_frame([ENC.tone_spectrum(30)]) * 6
    with pytest.raises(ValueError):
        decode_mp3_streams_device([a, mono])
