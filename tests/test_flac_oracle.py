"""Bit-exactness cross-checks against the reference's vendored flac-1.2.1.

Requires the oracle CLI (`bash tools/build_oracles.sh`); skipped otherwise.
Two directions:
  * our encoder's streams decode identically under libFLAC, and
  * streams produced by libFLAC's own encoder decode identically under our
    host-parse + device-synthesis path (the real parity claim: BASELINE.md's
    "bit-exact vs flac-1.2.1").
"""

import pathlib
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs import flac

ORACLE = pathlib.Path(__file__).resolve().parent.parent / ".oracle_build" / "flac_oracle"

pytestmark = pytest.mark.skipif(not ORACLE.exists(),
                                reason="flac oracle not built")


def tone(rate=44100, freq=997, seconds=0.5, bits=16, channels=2):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    amp = (1 << (bits - 1)) - 1
    return np.stack([
        np.rint(np.sin(2 * np.pi * freq * t + 0.1 * c) * amp)
        for c in range(channels)]).astype(np.int32)


def oracle_decode(data: bytes, tmp) -> np.ndarray:
    fin, fout = tmp / "in.flac", tmp / "out.raw"
    fin.write_bytes(data)
    subprocess.run([str(ORACLE), "decode", str(fin), str(fout)], check=True)
    return np.fromfile(fout, dtype=np.int32)


def oracle_encode(x: np.ndarray, rate: int, bits: int, tmp) -> bytes:
    fin, fout = tmp / "in.raw", tmp / "out.flac"
    np.ascontiguousarray(x.T).astype(np.int32).tofile(fin)
    subprocess.run([str(ORACLE), "encode", str(fin), str(fout), str(rate),
                    str(x.shape[0]), str(bits), str(x.shape[1])], check=True)
    return fout.read_bytes()


@pytest.mark.parametrize("bits,rate,ch", [(16, 44100, 2), (24, 96000, 2),
                                          (16, 48000, 1)])
def test_our_encoder_decodes_under_libflac(tmp_path, bits, rate, ch):
    x = tone(rate=rate, bits=bits, channels=ch)
    data = flac.encode_flac(x, rate, bits)
    got = oracle_decode(data, tmp_path)
    np.testing.assert_array_equal(got, x.T.reshape(-1))


@pytest.mark.parametrize("bits,rate,ch", [(16, 44100, 2), (24, 88200, 2),
                                          (16, 32000, 1), (24, 192000, 2)])
def test_libflac_streams_decode_bit_exact(tmp_path, bits, rate, ch):
    x = tone(rate=rate, bits=bits, channels=ch)
    data = oracle_encode(x, rate, bits, tmp_path)
    info, out = flac.decode_flac(data)
    assert info.sample_rate == rate and info.num_channels == ch
    np.testing.assert_array_equal(out, x)


def test_libflac_noise_stream_decodes_bit_exact(tmp_path, rng):
    x = rng.integers(-(1 << 22), 1 << 22, size=(2, 30000)).astype(np.int32)
    data = oracle_encode(x, 44100, 24, tmp_path)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)


def test_libflac_correlated_stereo_decodes_bit_exact(tmp_path, rng):
    # strongly correlated channels drive libFLAC into mid/side + high LPC
    base = tone(seconds=1.0)[0]
    noise = rng.integers(-50, 50, size=base.shape).astype(np.int32)
    x = np.stack([base, base + noise])
    data = oracle_encode(x, 44100, 16, tmp_path)
    _, out = flac.decode_flac(data)
    np.testing.assert_array_equal(out, x)
