"""Device (jax) CELT group synthesis vs the host decoder.

celt_jax runs denormalise/IMDCT/TDAC/comb/deemphasis as one scanned
device program; the host path in celt.py (conformance-tested <=1 LSB
vs the opus oracle) is the behaviour oracle here.  f32 matmuls vs the
host's f64 loops bound the agreement at a fraction of an int16 LSB.
"""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax.codecs.base import BufferReader
from ohpipeline_jax.codecs.opus import split_packet_frames
from ohpipeline_jax.codecs.opus.celt import CeltDecoderState, decode_frame
from ohpipeline_jax.codecs.opus import celt_jax
from ohpipeline_jax.codecs.opus_headers import parse_opus_head
from ohpipeline_jax.containers.ogg import OggReader

ORACLE = pathlib.Path(__file__).resolve().parent.parent \
    / ".oracle_build" / "opus_oracle"


def _encode(pcm: np.ndarray, bitrate: int) -> bytes:
    ch = pcm.shape[0]
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.ascontiguousarray(pcm.T).tofile(fin)
        subprocess.run([str(ORACLE), "encode", fin, fout, str(ch),
                        str(bitrate), "celt"], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def _content(seconds: float, ch: int, seed: int = 9) -> np.ndarray:
    rate = 48000
    t = np.arange(int(rate * seconds)) / rate
    rng = np.random.default_rng(seed)
    x = (np.sin(2 * np.pi * 800 * t) * 9000
         * (0.5 + 0.5 * np.sin(2 * np.pi * 1.1 * t))
         + rng.standard_normal(len(t)) * 700)
    # hard transients force short (transient) MDCT blocks
    for s in rng.integers(0, len(t) - 2000, size=max(2, int(seconds * 3))):
        x[s:s + 600] += 9000 * np.exp(-np.arange(600) / 60.0)
    x = np.clip(x, -32000, 32000)
    if ch == 2:
        return np.stack([x, np.roll(x, 17)]).astype(np.int16)
    return x[None, :].astype(np.int16)


def _host_decode(data: bytes) -> np.ndarray:
    """Raw synthesis-path decode (no pre-skip/gain trim): the exact
    target for celt_jax.decode_celt_stream_device."""
    packets = list(OggReader(BufferReader(data)).packets())
    head = parse_opus_head(packets[0])
    st = None
    outs = []
    for pk in packets[2:]:
        toc, frames = split_packet_frames(pk)
        assert toc.mode == "celt"
        sc = 2 if toc.stereo else 1
        if st is None:
            st = CeltDecoderState(sc)
        for f in frames:
            outs.append(decode_frame(st, f, 960))
    pcm = np.concatenate(outs, axis=1) * 32768.0
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("ch,bitrate", [(2, 96000), (1, 64000)])
def test_device_matches_host(ch, bitrate):
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    data = _encode(_content(1.5, ch), bitrate)
    ref = _host_decode(data)
    dev = celt_jax.decode_celt_stream_device(data, group=16)
    assert dev.shape == ref.shape
    err = np.abs(dev.astype(np.int32) - ref.astype(np.int32))
    sig = float(np.sqrt((ref.astype(np.float64) ** 2).mean()))
    rms = float(np.sqrt((err.astype(np.float64) ** 2).mean()))
    snr = 20 * np.log10(sig / max(rms, 1e-9))
    assert err.max() <= 2, (err.max(), snr)       # within 2 int16 LSBs
    assert snr >= 70.0, snr


def test_device_covers_transients_and_postfilter():
    """The stream the bounds are claimed on must actually exercise
    short (transient) blocks and an active pitch post-filter."""
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    data = _encode(_content(1.5, 2), 96000)
    _, caps = celt_jax.capture_stream(data)
    assert any(c["is_transient"] for c in caps)
    assert any(c["pf"][1][1] > 0 for c in caps)   # current gain active


def test_multi_stream_batch_matches_single():
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    a = _encode(_content(1.0, 2, seed=9), 96000)
    b = _encode(_content(1.0, 2, seed=10), 96000)
    singles = [celt_jax.decode_celt_stream_device(s, group=8)
               for s in (a, b)]
    n = min(s.shape[1] for s in singles)
    batch = celt_jax.decode_celt_streams_device([a, b], group=8)
    for i, s in enumerate(singles):
        np.testing.assert_array_equal(batch[i, :, :n], s[:, :n])


def test_entropy_only_state_matches_full_decode():
    """decode_frame(synthesis=False) must evolve the entropy-side state
    (energies, post-filter params, rng) exactly like a full decode."""
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    data = _encode(_content(1.0, 2), 96000)
    packets = list(OggReader(BufferReader(data)).packets())[2:]
    st_a = CeltDecoderState(2)
    st_b = CeltDecoderState(2)
    for pk in packets:
        _, frames = split_packet_frames(pk)
        for f in frames:
            decode_frame(st_a, f, 960)
            decode_frame(st_b, f, 960, synthesis=False)
        np.testing.assert_array_equal(st_a.old_ebands, st_b.old_ebands)
        np.testing.assert_array_equal(st_a.old_logE, st_b.old_logE)
        assert (st_a.pf_period, st_a.pf_gain, st_a.pf_tapset) \
            == (st_b.pf_period, st_b.pf_gain, st_b.pf_tapset)
        assert (st_a.pf_period_old, st_a.pf_gain_old) \
            == (st_b.pf_period_old, st_b.pf_gain_old)
        assert st_a.rng == st_b.rng
