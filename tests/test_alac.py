"""ALAC conformance vs the reference's apple_alac (oracle-gated):
bit-exact decode of oracle-encoded packets, and the M4A container path."""

import pathlib
import struct
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs import alac as AL

ORACLE = pathlib.Path(__file__).resolve().parent.parent / ".oracle_build" / "alac_oracle"

pytestmark = pytest.mark.skipif(not ORACLE.exists(),
                                reason="alac oracle not built")


def oracle_encode(pcm16: np.ndarray, rate: int, tmp):
    """(ch, n) int16 -> (cookie, packets)."""
    fin, fout = tmp / "in.raw", tmp / "out.alac"
    np.ascontiguousarray(pcm16.T).tofile(fin)
    subprocess.run([str(ORACLE), "encode", str(fin), str(fout), str(rate),
                    str(pcm16.shape[0])], check=True)
    raw = fout.read_bytes()
    clen = struct.unpack("<I", raw[:4])[0]
    cookie = raw[4:4 + clen]
    p = 4 + clen
    npk = struct.unpack("<I", raw[p:p + 4])[0]
    p += 4
    pkts = []
    for _ in range(npk):
        sz = struct.unpack("<I", raw[p:p + 4])[0]
        p += 4
        pkts.append(raw[p:p + sz])
        p += sz
    return cookie, pkts


def decode_all(cookie: bytes, pkts: list[bytes]) -> np.ndarray:
    cfg = AL.AlacConfig.parse(cookie)
    return np.concatenate([AL.decode_packet(p, cfg)[0] for p in pkts],
                          axis=1)


def tone(rate=44100, seconds=1.0, channels=2):
    t = np.arange(int(rate * seconds)) / rate
    return np.stack([
        np.clip(np.rint(np.sin(2 * np.pi * (997 + 13 * c) * t) * 20000),
                -32768, 32767).astype(np.int16) for c in range(channels)])


def test_stereo_tone_bit_exact(tmp_path):
    x = tone()
    cookie, pkts = oracle_encode(x, 44100, tmp_path)
    out = decode_all(cookie, pkts)
    np.testing.assert_array_equal(out[:, :x.shape[1]].astype(np.int16), x)


def test_mono_bit_exact(tmp_path):
    x = tone(channels=1)
    cookie, pkts = oracle_encode(x, 44100, tmp_path)
    out = decode_all(cookie, pkts)
    np.testing.assert_array_equal(out[:, :x.shape[1]].astype(np.int16), x)


def test_noise_bit_exact(tmp_path, rng):
    # noise drives escape/verbatim and high rice activity
    x = rng.integers(-32768, 32768, size=(2, 30000)).astype(np.int16)
    cookie, pkts = oracle_encode(x, 44100, tmp_path)
    out = decode_all(cookie, pkts)
    np.testing.assert_array_equal(out[:, :x.shape[1]].astype(np.int16), x)


def test_correlated_stereo_bit_exact(tmp_path, rng):
    base = tone()[0].astype(np.int32)
    x = np.stack([base, base + rng.integers(-64, 64, base.shape)]) \
        .astype(np.int16)
    cookie, pkts = oracle_encode(x, 44100, tmp_path)
    out = decode_all(cookie, pkts)
    np.testing.assert_array_equal(out[:, :x.shape[1]].astype(np.int16), x)


def test_m4a_container_path(tmp_path):
    from ohpipeline_jax.codecs.base import BufferReader, EndOfStream
    from ohpipeline_jax.containers.mpeg4 import write_m4a
    x = tone(seconds=0.7)
    cookie, pkts = oracle_encode(x, 44100, tmp_path)
    m4a = write_m4a(pkts, cookie, 44100, 2, codec="alac",
                    samples_per_frame=4096)
    codec = AL.CodecAlac()
    assert codec.recognise(m4a[:16384])
    r = BufferReader(m4a)
    info = codec.stream_initialise(r)
    assert info.codec_name == "ALAC" and info.lossless
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    out = np.concatenate(parts, axis=1)
    np.testing.assert_array_equal(out[:, :x.shape[1]].astype(np.int16), x)


def test_registry_disambiguates_mp4(tmp_path):
    """ALAC-in-MP4 and AAC-in-MP4 both use ftyp; the registry must pick by
    track codec."""
    from ohpipeline_jax.codecs import default_registry
    from ohpipeline_jax.containers.mpeg4 import write_m4a
    x = tone(seconds=0.3)
    cookie, pkts = oracle_encode(x, 44100, tmp_path)
    m4a = write_m4a(pkts, cookie, 44100, 2, codec="alac",
                    samples_per_frame=4096)
    codec = default_registry.recognise(m4a[:16384])
    assert codec is not None and codec.name == "ALAC"
