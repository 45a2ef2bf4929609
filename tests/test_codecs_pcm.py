"""Tests for the uncompressed codec family (WAV/AIFF/AIFC/PCM/DSD).

Mirrors the reference's TestCodec strategy (SURVEY.md §4.2): synthesise
1 kHz sine tones, encode, decode, assert stream params and zero-crossing
cadence of the reconstruction.
"""

import numpy as np
import pytest

from ohpipeline_jax import codecs
from ohpipeline_jax.codecs import aiff, dsd, wav
from ohpipeline_jax.codecs.base import BufferReader, EndOfStream


def sine_tone(rate=44100, freq=1000, seconds=1.0, bits=16, channels=2):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    amp = (1 << (bits - 1)) - 1
    s = np.rint(np.sin(2 * np.pi * freq * t) * amp).astype(np.int32)
    return np.tile(s, (channels, 1))


def decode_all(codec, data):
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).samples)
        except EndOfStream:
            break
    return info, np.concatenate(parts, axis=1)


def count_zero_crossings(x):
    s = np.signbit(x.astype(np.int64))
    return int(np.count_nonzero(s[1:] != s[:-1]))


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("rate", [44100, 48000])
def test_wav_roundtrip_tone(bits, rate):
    tone = sine_tone(rate=rate, bits=bits)
    data = wav.write_wav(tone, rate, bits)
    codec = wav.CodecWav()
    assert codec.recognise(data[:16])
    info, out = decode_all(codec, data)
    assert (info.sample_rate, info.bit_depth, info.num_channels) == (rate, bits, 2)
    np.testing.assert_array_equal(out, tone)
    # TestCodec-style check: ~2 crossings per 1kHz cycle over 1s
    assert abs(count_zero_crossings(out[0]) - 2000) <= 2


def test_aiff_roundtrip_tone():
    tone = sine_tone(bits=24)
    data = aiff.write_aiff(tone, 44100, 24)
    codec = aiff.CodecAiff()
    assert codec.recognise(data[:16])
    info, out = decode_all(codec, data)
    assert info.codec_name == "AIFF"
    assert (info.sample_rate, info.bit_depth) == (44100, 24)
    np.testing.assert_array_equal(out, tone)


def test_aiff_extended80_rates():
    for rate in (7350, 44100, 48000, 192000, 384000):
        assert aiff._decode_extended80(aiff.encode_extended80(rate)) == rate


def test_wav_rejects_garbage():
    codec = wav.CodecWav()
    assert not codec.recognise(b"\x00" * 16)
    with pytest.raises(codecs.CodecStreamCorrupt):
        codec.stream_initialise(BufferReader(b"RIFFxxxxWAVEjunk" + b"\x00" * 64))


def test_registry_recognition():
    tone = sine_tone(seconds=0.01)
    assert codecs.default_registry.recognise(
        wav.write_wav(tone, 44100, 16)[:64]).name == "WAV"
    assert codecs.default_registry.recognise(
        aiff.write_aiff(tone, 44100, 16)[:64]).name == "AIFF"
    assert codecs.default_registry.recognise(b"\x00" * 64) is None


def test_dsf_decode():
    # Build a tiny DSF: 2 channels, one 4096-byte block each, LSB-first bits.
    import struct
    channels, rate = 2, 2_822_400
    payload = bytes(range(256)) * 16  # 4096 bytes
    blocks = payload * channels
    dsd_chunk = struct.pack("<4sQQQ", b"DSD ", 28, 28 + 52 + 12 + len(blocks), 0)
    fmt = struct.pack("<4sQIIIIIIQII", b"fmt ", 52, 1, 0, 2, channels, rate,
                      1, 4096 * 8, 4096, 0)
    data_hdr = struct.pack("<4sQ", b"data", 12 + len(blocks))
    stream = dsd_chunk + fmt + data_hdr + blocks
    codec = dsd.CodecDsdDsf()
    assert codec.recognise(stream[:16])
    r = BufferReader(stream)
    info = codec.stream_initialise(r)
    assert info.sample_rate == rate and info.num_channels == 2
    batch = codec.process(r)
    assert batch.samples.shape == (2, 4096)
    # check LSB->MSB bit reversal: byte 0x01 on disk -> 0x80 normalised
    assert batch.samples[0, 1] == 0x80


def test_dff_decode():
    import struct
    rate, channels = 2_822_400, 2
    payload = bytes([0xAA, 0x55] * 100)  # interleaved L,R
    fs = struct.pack(">4sQI", b"FS  ", 4, rate)
    chnl = struct.pack(">4sQH2s2s", b"CHNL", 10, 2, b"SLFT", b"SRGT")[:22]
    prop_body = b"SND " + fs + chnl
    prop = struct.pack(">4sQ", b"PROP", len(prop_body)) + prop_body
    dsdc = struct.pack(">4sQ", b"DSD ", len(payload)) + payload
    body = b"DSD " + prop + dsdc
    stream = struct.pack(">4sQ", b"FRM8", len(body) + 4) + body
    codec = dsd.CodecDsdDff()
    assert codec.recognise(stream[:16])
    r = BufferReader(stream)
    info = codec.stream_initialise(r)
    assert info.sample_rate == rate and info.num_channels == channels
    batch = codec.process(r)
    assert batch.samples[0, 0] == 0xAA and batch.samples[1, 0] == 0x55
