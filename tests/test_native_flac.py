"""Native (C++) FLAC unpacker vs the Python reference parser: identical
batch arrays, identical decoded PCM."""

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs import flac
from ohpipeline_jax.codecs.flac import frames as FF
from ohpipeline_jax.codecs.flac.bitreader import BitReader

pytestmark = pytest.mark.skipif(not native.have_flac_unpack(),
                                reason="g++ unavailable")


def _encode(rng, n=20000, bits=16, ch=2, rate=44100, noise=False):
    if noise:
        x = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                         size=(ch, n)).astype(np.int32)
    else:
        t = np.arange(n) / rate
        amp = (1 << (bits - 1)) - 1
        x = np.stack([np.rint(np.sin(2 * np.pi * (997 + 7 * c) * t) * amp)
                      for c in range(ch)]).astype(np.int32)
    return x, flac.encode_flac(x, rate, bits)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("bits,ch", [(16, 2), (24, 2), (16, 1)])
def test_native_matches_python_parser(rng, noise, bits, ch):
    x, data = _encode(rng, bits=bits, ch=ch, noise=noise)
    meta = FF.parse_metadata(data)
    si = meta.streaminfo
    n, pos, status, batch = native.flac_parse_group(
        data, meta.header_bytes * 8, sample_rate=si.sample_rate,
        bits_per_sample=si.bits_per_sample, max_blocksize=si.max_blocksize,
        channels=si.channels, max_frames=64)
    assert status == 0
    # python reference parse
    br = BitReader(data, meta.header_bytes * 8)
    pyframes = []
    while True:
        try:
            pyframes.append(FF.parse_frame(br, si))
        except (EOFError, FF.FlacError, ValueError):
            break
    assert n == len(pyframes)
    for fi, fr in enumerate(pyframes):
        assert batch["assign"][fi] == fr.header.assignment
        assert batch["blocksize"][fi] == fr.header.blocksize
        assert batch["sample_number"][fi] == fr.header.sample_number
        for ci, sub in enumerate(fr.subframes):
            b = fi * si.channels + ci
            assert batch["order"][b] == sub.order
            assert batch["shift"][b] == sub.shift
            assert batch["wasted"][b] == sub.wasted_bits
            np.testing.assert_array_equal(
                batch["data"][b, :len(sub.data)], sub.data)
            np.testing.assert_array_equal(
                batch["coeffs"][b, :len(sub.coeffs)], sub.coeffs)


def test_native_handles_corruption(rng):
    x, data = _encode(rng)
    meta = FF.parse_metadata(data)
    si = meta.streaminfo
    bad = bytearray(data)
    bad[meta.header_bytes + 100] ^= 0xFF
    n, pos, status, batch = native.flac_parse_group(
        bytes(bad), meta.header_bytes * 8, sample_rate=si.sample_rate,
        bits_per_sample=si.bits_per_sample, max_blocksize=si.max_blocksize,
        channels=si.channels, max_frames=64)
    assert status == 1          # resync happened
    assert n >= len(x[0]) // 4096 - 2   # lost at most the damaged frame


def test_native_partial_buffer_stops_clean(rng):
    x, data = _encode(rng)
    meta = FF.parse_metadata(data)
    si = meta.streaminfo
    cut = data[: len(data) // 2]
    n, pos, status, _ = native.flac_parse_group(
        cut, meta.header_bytes * 8, sample_rate=si.sample_rate,
        bits_per_sample=si.bits_per_sample, max_blocksize=si.max_blocksize,
        channels=si.channels, max_frames=64)
    assert 0 < n
    assert pos <= len(cut) * 8
