"""FLAC conformance: lossless roundtrips through every subframe/stereo
shape, bitreader primitives, corrupt-stream rejection.

Mirrors the reference's TestCodec strategy (SURVEY.md §4.2): sine tones at
multiple rate/depth/channel combos, exact sample counts, seek-and-reverify.
FLAC is lossless, so encoder->decoder roundtrip equality is also bit-exact
parity with flac-1.2.1 on these streams (cross-checked against the compiled
reference decoder in test_flac_oracle.py when the oracle is built).
"""

import numpy as np
import pytest

from ohpipeline_jax.codecs import flac
from ohpipeline_jax.codecs.flac import bitreader as BR
from ohpipeline_jax.codecs.flac import frames as FF


def tone(rate=44100, freq=1000, seconds=0.5, bits=16, channels=2, phase=0.0):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    amp = (1 << (bits - 1)) - 1
    out = np.stack([
        np.rint(np.sin(2 * np.pi * freq * t + phase + 0.1 * c) * amp)
        for c in range(channels)]).astype(np.int32)
    return out


class TestBitIo:
    def test_read_write_fields(self, rng):
        bw = BR.BitWriter()
        fields = [(int(rng.integers(0, 1 << w)), w)
                  for w in rng.integers(1, 32, size=200)]
        for v, w in fields:
            bw.write(v, int(w))
        bw.align_byte()
        br = BR.BitReader(bw.getvalue())
        for v, w in fields:
            assert br.read(int(w)) == v

    def test_unary(self):
        bw = BR.BitWriter()
        for q in (0, 1, 7, 8, 31, 100, 1000):
            bw.write_unary(q)
        bw.align_byte()
        br = BR.BitReader(bw.getvalue())
        for q in (0, 1, 7, 8, 31, 100, 1000):
            assert br.read_unary() == q

    def test_rice_roundtrip(self, rng):
        for param in (0, 1, 4, 10):
            vals = rng.integers(-5000, 5000, size=100)
            bw = BR.BitWriter()
            for v in vals:
                bw.write_rice(int(v), param)
            bw.align_byte()
            br = BR.BitReader(bw.getvalue())
            for v in vals:
                assert br.read_rice(param) == v

    def test_utf8_coded(self):
        for v in (0, 1, 127, 128, 2047, 2048, 65535, 1 << 20, 1 << 30,
                  (1 << 36) - 1):
            bw = BR.BitWriter()
            bw.write_utf8_coded(v)
            bw.align_byte()
            assert BR.BitReader(bw.getvalue()).read_utf8_coded() == v

    def test_crc8_known(self):
        # CRC-8/ATM of "123456789" is 0xF4
        assert BR.crc8(b"123456789") == 0xF4

    def test_crc16_known(self):
        # CRC-16/BUYPASS (poly 0x8005, init 0) of "123456789" is 0xFEE8
        assert BR.crc16(b"123456789") == 0xFEE8


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("rate", [44100, 48000])
def test_roundtrip_tone(bits, rate):
    x = tone(rate=rate, bits=bits)
    data = flac.encode_flac(x, rate, bits)
    info, out = flac.decode_flac(data)
    assert (info.sample_rate, info.bit_depth, info.num_channels) == (rate, bits, 2)
    np.testing.assert_array_equal(out, x)


def test_roundtrip_mono_and_multichannel(rng):
    for ch in (1, 3, 6):
        x = rng.integers(-(1 << 15), 1 << 15, size=(ch, 5000)).astype(np.int32)
        data = flac.encode_flac(x, 48000, 16)
        _, out = flac.decode_flac(data)
        np.testing.assert_array_equal(out, x)


def test_roundtrip_noise_exercises_verbatim(rng):
    x = rng.integers(-(1 << 23), 1 << 23, size=(2, 9000)).astype(np.int32)
    data = flac.encode_flac(x, 44100, 24)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)


def test_roundtrip_silence_and_dc():
    x = np.zeros((2, 8192), np.int32)
    x[1, :] = -123  # constant subframe
    data = flac.encode_flac(x, 44100, 16)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)
    assert len(data) < 2000  # constant frames are tiny


def test_roundtrip_wasted_bits():
    x = tone(bits=16)
    x = (x >> 4) << 4   # low 4 bits zero in every sample
    data = flac.encode_flac(x, 44100, 16)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)


def test_roundtrip_short_tail_block():
    x = tone(seconds=0.123)   # not a multiple of 4096
    data = flac.encode_flac(x, 44100, 16)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)


def test_all_stereo_assignments_decode(rng):
    # force each assignment by constructing correlated/anticorrelated content
    base = tone(seconds=0.2)[0]
    cases = [
        np.stack([base, base]),                          # mid/side-ish
        np.stack([base, rng.integers(-100, 100, base.shape).astype(np.int32)]),
        np.stack([rng.integers(-100, 100, base.shape).astype(np.int32), base]),
    ]
    for x in cases:
        data = flac.encode_flac(x, 44100, 16)
        _, out = flac.decode_flac(data)
        np.testing.assert_array_equal(out, x)


def test_fixed_only_encoder_path():
    x = tone(seconds=0.2)
    data = flac.encode_flac(x, 44100, 16, use_lpc=False)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)


def test_metadata_parse_and_total_samples():
    x = tone(seconds=0.25)
    data = flac.encode_flac(x, 44100, 16)
    meta = FF.parse_metadata(data)
    si = meta.streaminfo
    assert si.total_samples == x.shape[1]
    assert si.sample_rate == 44100 and si.channels == 2


def test_corrupt_frame_crc_is_skipped_not_crash():
    x = tone(seconds=0.3)
    data = bytearray(flac.encode_flac(x, 44100, 16))
    meta = FF.parse_metadata(bytes(data))
    # flip a bit inside the first frame's audio payload
    data[meta.header_bytes + 40] ^= 0x10
    info, out = flac.decode_flac(bytes(data))
    # must not crash; decodes the undamaged remainder
    assert out.shape[0] == 2
    assert out.shape[1] <= x.shape[1]


def test_not_flac_rejected():
    from ohpipeline_jax.codecs.base import BufferReader, CodecStreamCorrupt
    codec = flac.CodecFlac()
    assert not codec.recognise(b"RIFFxxxx")
    with pytest.raises(CodecStreamCorrupt):
        codec.stream_initialise(BufferReader(b"garbage" * 100))


@pytest.mark.parametrize("use_native", [True, False])
def test_one_program_shape_across_tail_and_seek(use_native):
    """Full groups, the short last group and the groups after a seek all
    run the group program at one shape, so a stream compiles it once;
    the samples after the seek equal the source's tail."""
    from ohpipeline_jax.codecs.base import BufferReader, EndOfStream
    x = tone(seconds=1.2)                 # 51 full frames + a short one
    data = flac.encode_flac(x, 44100, 16, blocksize=1024)
    flac._synthesise_group.clear_cache()
    codec = flac.CodecFlac(use_native=use_native)
    reader = BufferReader(data)
    codec.stream_initialise(reader)
    head = codec.process(reader).resolve()
    np.testing.assert_array_equal(head, x[:, :head.shape[1]])
    pos = codec.try_seek(x.shape[1] // 2)
    assert reader.try_seek_bytes(pos)
    codec.notify_seek_done(pos)
    parts = []
    while True:
        try:
            parts.append(codec.process(reader).resolve())
        except EndOfStream:
            break
    tail = np.concatenate(parts, axis=1)
    assert x.shape[1] // 3 < tail.shape[1] < x.shape[1] - head.shape[1]
    np.testing.assert_array_equal(tail, x[:, x.shape[1] - tail.shape[1]:])
    assert flac._synthesise_group._cache_size() == 1
