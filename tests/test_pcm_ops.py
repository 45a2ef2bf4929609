"""Tests for ops.pcm — fused gain chain, decorrelation, byte conversion."""

import numpy as np
import jax.numpy as jnp
import pytest

from ohpipeline_jax.ops import pcm


def test_unity_gain_is_bit_exact(rng):
    tile = rng.integers(-(1 << 23), 1 << 23, size=(4, 2, 256), dtype=np.int32)
    out = pcm.apply_gain(jnp.asarray(tile),
                         jnp.ones(4, jnp.float32),
                         jnp.ones(4, jnp.float32),
                         jnp.ones(4, jnp.float32))
    np.testing.assert_array_equal(np.asarray(out), tile)


def test_ramp_line_matches_scalar_model(rng):
    tile = rng.integers(-(1 << 15), 1 << 15, size=(2, 1, 64), dtype=np.int32)
    rs = np.array([0.0, 1.0], np.float32)
    re = np.array([1.0, 0.25], np.float32)
    g = np.array([0.5, 1.0], np.float32)
    out = np.asarray(pcm.apply_gain(jnp.asarray(tile), jnp.asarray(rs),
                                    jnp.asarray(re), jnp.asarray(g)))
    n = np.arange(64, dtype=np.float32) / 64
    for b in range(2):
        line = (rs[b] + (re[b] - rs[b]) * n) * g[b]
        expect = np.rint(tile[b, 0].astype(np.float32) * line).astype(np.int32)
        np.testing.assert_array_equal(out[b, 0], expect)


def test_mute_full_zero(rng):
    tile = rng.integers(-(1 << 23), 1 << 23, size=(1, 2, 32), dtype=np.int32)
    out = pcm.apply_gain(jnp.asarray(tile), jnp.ones(1, jnp.float32),
                         jnp.ones(1, jnp.float32), jnp.zeros(1, jnp.float32))
    assert not np.asarray(out).any()


def test_attenuate_matches_integer_model(rng):
    tile = rng.integers(-(1 << 23), 1 << 23, size=(3, 2, 128), dtype=np.int32)
    att = np.array([pcm.UNITY_ATTENUATION, 1 << 13, 3333], np.int32)
    out = np.asarray(pcm.attenuate(jnp.asarray(tile), jnp.asarray(att)))
    expect = (tile.astype(np.int64) * att[:, None, None]) >> 14
    np.testing.assert_array_equal(out, expect.astype(np.int32))
    # unity attenuation is exact passthrough
    np.testing.assert_array_equal(out[0], tile[0])


def test_bit_depth_convert_roundtrip(rng):
    t16 = rng.integers(-(1 << 15), 1 << 15, size=(2, 2, 64), dtype=np.int32)
    up = pcm.bit_depth_convert(jnp.asarray(t16),
                               jnp.full(2, 16, jnp.int32),
                               jnp.full(2, 24, jnp.int32))
    np.testing.assert_array_equal(np.asarray(up), t16 << 8)
    back = pcm.bit_depth_convert(up, jnp.full(2, 24, jnp.int32),
                                 jnp.full(2, 16, jnp.int32))
    np.testing.assert_array_equal(np.asarray(back), t16)


def test_stereo_decorrelate_roundtrip(rng):
    # Encode l/r into each decorrelation mode the way a FLAC encoder does,
    # then assert the device op reconstructs the originals.
    B, N = 4, 100
    left = rng.integers(-(1 << 15), 1 << 15, size=(B, N)).astype(np.int64)
    right = rng.integers(-(1 << 15), 1 << 15, size=(B, N)).astype(np.int64)
    mode = np.array([pcm.CH_INDEPENDENT, pcm.CH_LEFT_SIDE,
                     pcm.CH_RIGHT_SIDE, pcm.CH_MID_SIDE], np.int32)
    ch0 = np.empty_like(left)
    ch1 = np.empty_like(right)
    ch0[0], ch1[0] = left[0], right[0]
    ch0[1], ch1[1] = left[1], left[1] - right[1]           # left/side
    ch0[2], ch1[2] = left[2] - right[2], right[2]          # right/side
    ch0[3] = (left[3] + right[3]) >> 1                     # mid/side
    ch1[3] = left[3] - right[3]
    l2, r2 = pcm.stereo_decorrelate(jnp.asarray(ch0, jnp.int32),
                                    jnp.asarray(ch1, jnp.int32),
                                    jnp.asarray(mode))
    np.testing.assert_array_equal(np.asarray(l2), left.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(r2), right.astype(np.int32))


@pytest.mark.parametrize("bits,be", [(8, False), (16, False), (16, True),
                                     (24, False), (24, True), (32, False),
                                     (32, True)])
def test_pack_unpack_roundtrip(rng, bits, be):
    lo, hi = pcm.native_limits(bits)
    s = rng.integers(lo, hi + 1, size=(2, 97)).astype(np.int32)
    data = pcm.pack_pcm_bytes(s, bits, big_endian=be)
    assert len(data) == 2 * 97 * bits // 8
    back = pcm.unpack_pcm_bytes(data, bits, 2, big_endian=be)
    np.testing.assert_array_equal(back, s)


def test_unpack_float_formats():
    f = np.array([0.0, 0.5, -0.5, 1.0, -1.0], np.float32)
    inter = np.repeat(f, 2)  # stereo, both channels equal
    out = pcm.unpack_pcm_bytes(inter.tobytes(), 32, 2, float_format=True)
    expect = np.clip(np.rint(f * (1 << 23)), -(1 << 23), (1 << 23) - 1)
    np.testing.assert_array_equal(out[0], expect.astype(np.int32))
    np.testing.assert_array_equal(out[1], out[0])


def test_unpack_unsigned8():
    data = bytes([0, 128, 255])
    out = pcm.unpack_pcm_bytes(data, 8, 1, signed=False)
    np.testing.assert_array_equal(out[0], [-128, 0, 127])
