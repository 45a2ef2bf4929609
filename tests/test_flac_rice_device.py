"""Device-side FLAC rice decode (codecs/flac/rice_jax.py).

The rice wire ships the entropy-coded stream bytes themselves to the
device and decodes the rice codes there (displacing the reference's
host bitreader, flac-1.2.1 src/libFLAC/bitreader.c, for the batched
serving path).  These tests drive the full native-parse -> slab ->
device-decode -> synthesis path and require bit-exact agreement with
the host decoder on every subframe/partition shape the encoder can
produce: LPC/fixed with rice partitions, constant subframes, verbatim
escape partitions, wasted bits, over-window codewords (escape triples),
and short final frames.
"""

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs import flac
from ohpipeline_jax.codecs.flac import frames as FF
from ohpipeline_jax.codecs.flac import _synthesise_group_rice

pytestmark = pytest.mark.skipif(not native.have_flac_unpack(),
                                reason="native flac unpacker unavailable")


def _decode_rice_wire(data: bytes, max_frames: int = 64,
                      chunk_frames: int = 8) -> np.ndarray:
    """Decode a FLAC stream through the rice wire in several groups
    (exercising cursor rebasing into a shared slab) and return (N, C)
    int32 PCM."""
    meta = FF.parse_metadata(data)
    si = meta.streaminfo
    stride = si.max_blocksize
    if stride % 64:
        stride += 64 - stride % 64
    nch = si.channels
    pos = meta.header_bytes * 8
    out = []
    scratch = np.zeros((chunk_frames * nch, stride), np.int32)
    while True:
        B = chunk_frames * nch
        gcur = np.zeros((B, stride // 64), np.int32)
        gk = np.zeros((B, stride // 64), np.int8)
        warm = np.zeros((B, 32), np.int32)
        over = native.RiceOverflow(4096)
        cfill = native.RiceConstFill(256)
        esc = native.EscapeList(1 << 16)
        n, pos, status, batch, (b0, b1) = native.flac_parse_group_rice(
            data, pos, gcur, gk, warm, scratch, over, cfill, esc, 0,
            sample_rate=si.sample_rate, bits_per_sample=si.bits_per_sample,
            max_blocksize=stride, channels=nch, max_frames=chunk_frames)
        assert status >= 0, f"parser status {status}"
        if n == 0:
            break
        # slab: raw stream bytes at a nonzero base (cursor rebase check)
        base = 128
        nb = b1 - b0
        slab = np.zeros(base + nb + (-(base + nb) % 4) + 8, np.uint8)
        slab[base:base + nb] = np.frombuffer(data[b0:b1], np.uint8)
        gcur[gk >= 0] += base * 8
        oc = over.count.value
        over.cur[:oc] += base * 8
        pcm = np.asarray(_synthesise_group_rice(
            slab, gcur, gk,
            over.cur, over.k, over.mode, over.cnt, over.row, over.pos,
            cfill.row, cfill.val, cfill.n, warm,
            esc.row, esc.pos, esc.val,
            batch["coeffs"], batch["shift"], batch["order"],
            batch["wasted"], batch["assign"], nch))
        for f in range(n):
            bs = int(batch["blocksize"][f])
            out.append(pcm[f, :, :bs].T)
    assert out, "no frames decoded"
    return np.concatenate(out, axis=0)


def _roundtrip(track: np.ndarray, rate: int = 44100) -> None:
    """track: (channels, n) int PCM."""
    enc = flac.encode_flac(track, rate, 16)
    info, ref = flac.decode_flac(enc)          # (channels, n)
    got = _decode_rice_wire(enc)               # (n, channels)
    assert got.shape == ref.T.shape
    assert np.array_equal(got, ref.T), (
        f"mismatch at {np.argwhere(got != ref.T)[:4]}")


def _tone_track(seconds=1.3, rate=44100, seed=7):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = (0.5 * np.sin(2 * np.pi * 523 * t)
         + 0.2 * np.sin(2 * np.pi * 97 * t)
         + 0.02 * rng.standard_normal(n))
    st = np.stack([x, np.roll(x, 17) * 0.8], axis=0)
    return np.clip(st * 32000, -32768, 32767).astype(np.int32)


def test_tones_noise_stereo():
    _roundtrip(_tone_track())


def test_silence_constant_subframes():
    n = 44100
    track = np.zeros((2, n), np.int32)
    track[0, 30000:30100] = 12000       # one burst between silent frames
    _roundtrip(track)


def test_dc_constant_value():
    track = np.full((2, 20000), -1234, np.int32)
    _roundtrip(track)


def test_white_noise_large_k():
    rng = np.random.default_rng(3)
    track = rng.integers(-32768, 32768, (2, 44100)).astype(np.int32)
    _roundtrip(track)


def test_impulse_spikes_escape_codewords():
    # near-silence with rare huge spikes: the partition's optimal k is
    # tiny, so the spike's quotient blows past the device window and
    # must ride the escape path
    rng = np.random.default_rng(4)
    track = rng.integers(-2, 3, (2, 44100)).astype(np.int32)
    pos = rng.integers(0, 44100, 24)
    track[0, pos] = 32000
    track[1, pos] = -32000
    _roundtrip(track)


def test_wasted_bits():
    rng = np.random.default_rng(5)
    x = (rng.integers(-2048, 2048, (2, 30000)) << 4).astype(np.int32)
    _roundtrip(x)


def test_short_final_frame_and_mono():
    rng = np.random.default_rng(6)
    n = 4096 * 3 + 777                   # non-multiple => short last frame
    t = np.arange(n) / 44100.0
    x = np.clip(20000 * np.sin(2 * np.pi * 441 * t)
                + 300 * rng.standard_normal(n),
                -32768, 32767).astype(np.int32)
    _roundtrip(x[None, :])


def test_escape_count_matches_window_rule():
    # the host must escape exactly the codewords whose quotient > 15 or
    # whose total length > 32 bits; on plain tonal content none should
    enc = flac.encode_flac(_tone_track(seconds=0.6), 44100, 16)
    meta = FF.parse_metadata(enc)
    si = meta.streaminfo
    stride = si.max_blocksize + (-si.max_blocksize) % 64
    B = 64 * si.channels
    gcur = np.zeros((B, stride // 64), np.int32)
    gk = np.zeros((B, stride // 64), np.int8)
    warm = np.zeros((B, 32), np.int32)
    scratch = np.zeros((B, stride), np.int32)
    over = native.RiceOverflow(4096)
    cfill = native.RiceConstFill(64)
    esc = native.EscapeList(1 << 14)
    n, _pos, status, _b, _rng = native.flac_parse_group_rice(
        enc, meta.header_bytes * 8, gcur, gk, warm, scratch, over, cfill,
        esc, 0, sample_rate=si.sample_rate,
        bits_per_sample=si.bits_per_sample, max_blocksize=stride,
        channels=si.channels, max_frames=64)
    assert n > 0 and status == 0
    assert esc.count.value == 0
    # grid coverage should dominate: most units are aligned full slots
    used = int((gk[:n * si.channels] >= 0).sum())
    assert used > over.count.value
