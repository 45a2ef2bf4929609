"""Multi-stream batched device FLAC decode (codecs/flac/serving.py)
must be bit-exact vs the host decode_flac across mixed bit depths,
lengths, blocksize tails and group boundaries."""

import numpy as np

from ohpipeline_jax.codecs import flac
from ohpipeline_jax.codecs.flac.serving import decode_flac_streams_device


def _track(seed, seconds, rate=44100, amp=20000):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f1 = 200 + 1500 * rng.random()
    x = (np.sin(2 * np.pi * f1 * t) * 0.7
         + 0.05 * rng.standard_normal(n))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)
    return np.stack([np.rint(x * env * amp),
                     np.rint(np.roll(x, 17) * amp * 0.8)]).astype(np.int32)


def test_streams_device_bit_exact_mixed():
    streams, refs = [], []
    for seed, secs, bits in ((1, 1.0, 16), (2, 1.7, 16), (3, 0.6, 24)):
        amp = 20000 if bits == 16 else 5_000_000
        tone = _track(seed, secs, amp=amp)
        data = flac.encode_flac(tone, 44100, bits)
        streams.append(data)
        refs.append(flac.decode_flac(data)[1])
    outs = decode_flac_streams_device(streams, frames_per_group=4)
    assert len(outs) == 3
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_single_stream_single_group():
    tone = _track(9, 0.4)
    data = flac.encode_flac(tone, 44100, 16)
    ref = flac.decode_flac(data)[1]
    out = decode_flac_streams_device([data], frames_per_group=64)[0]
    np.testing.assert_array_equal(out, ref)
