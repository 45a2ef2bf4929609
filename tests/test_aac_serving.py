"""Multi-stream batched device AAC-LC decode (codecs/aac/serving.py)
vs the host per-frame decode (decode_adts, itself ~1 LSB vs fdk)."""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import native

pytestmark = pytest.mark.skipif(not native.have_aac_unpack(),
                                reason="native unpacker unavailable")

ORACLE = pathlib.Path(__file__).resolve().parent.parent / \
    ".oracle_build" / "aac_oracle"


def _encode(track: np.ndarray, rate: int, bitrate: int = 128000) -> bytes:
    if not ORACLE.exists():
        pytest.skip("aac oracle not built")
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([str(ORACLE), "encode", fin, fout, str(rate), "2",
                        str(bitrate)], check=True, capture_output=True)
        return open(fout, "rb").read()


def _content(seed, seconds, rate=44100):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = (np.sin(2 * np.pi * (300 + 400 * rng.random()) * t) * 11000
         + rng.standard_normal(n) * 700)
    # transients force short windows (and the pooled ssf path)
    for p in rng.integers(0, n - 500, 3):
        x[p:p + 300] += 14000 * np.sign(np.sin(2 * np.pi * 55
                                               * t[:300]))
    return np.clip(np.stack([x, np.roll(x, 11)]), -32000,
                   32000).astype(np.int32)


def test_streams_device_matches_host():
    from ohpipeline_jax.codecs.aac import decode_adts
    from ohpipeline_jax.codecs.aac.serving import decode_aac_streams_device
    streams = [_encode(_content(i, 1.2 + 0.4 * i), 44100)
               for i in range(3)]
    refs = [decode_adts(s)[1] for s in streams]
    outs = decode_aac_streams_device(streams, frames_per_group=16)
    assert len(outs) == 3
    for got, ref in zip(outs, refs):
        n = min(got.shape[1], ref.shape[1])
        assert abs(got.shape[1] - ref.shape[1]) <= 2 * 1024
        d = np.abs(got[:, :n].astype(np.float64) - ref[:, :n])
        assert d.max() <= 2.0, d.max()        # <= 2 LSB of int16 scale


def test_single_stream_group_boundaries():
    from ohpipeline_jax.codecs.aac import decode_adts
    from ohpipeline_jax.codecs.aac.serving import decode_aac_streams_device
    data = _encode(_content(9, 0.9), 44100)
    ref = decode_adts(data)[1]
    for g in (8, 64):
        out = decode_aac_streams_device([data], frames_per_group=g)[0]
        n = min(out.shape[1], ref.shape[1])
        d = np.abs(out[:, :n].astype(np.float64) - ref[:, :n])
        assert d.max() <= 2.0, (g, d.max())


def _encode_he(track: np.ndarray, rate: int, bitrate: int = 48000) -> bytes:
    if not ORACLE.exists():
        pytest.skip("aac oracle not built")
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([str(ORACLE), "encode", fin, fout, str(rate), "2",
                        str(bitrate), "2", "5"], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def test_he_streams_device_matches_codec():
    """decode_he_streams_device (all streams' channels in one SBR
    dispatch per group) vs the single-stream codec path (itself
    conformance-bounded vs libSBRdec) across ragged stream lengths and
    a group size different from the codec's."""
    from ohpipeline_jax.codecs.aac import decode_adts
    from ohpipeline_jax.codecs.aac.serving import decode_he_streams_device
    streams = [_encode_he(_content(20 + i, 1.6 + 0.5 * i), 44100)
               for i in range(3)]
    refs = [decode_adts(s)[1] for s in streams]
    outs = decode_he_streams_device(streams, frames_per_group=24)
    assert len(outs) == 3
    for got, ref in zip(outs, refs):
        n = min(got.shape[1], ref.shape[1])
        assert n > 44100        # both decoded >1 s at the doubled rate
        assert abs(got.shape[1] - ref.shape[1]) <= 2 * 2048
        d = np.abs(got[:, :n].astype(np.float64) - ref[:, :n])
        assert d.max() <= 2.0, d.max()


def test_clipping_content_matches_host():
    """Content with inter-sample overs (short windows + TNS + loud
    transients): both paths must saturate identically at int16."""
    from ohpipeline_jax.codecs.aac import decode_adts
    from ohpipeline_jax.codecs.aac.serving import decode_aac_streams_device
    data = _encode(_content(42, 1.0), 44100)
    ref = decode_adts(data)[1]
    out = decode_aac_streams_device([data], frames_per_group=16)[0]
    n = min(out.shape[1], ref.shape[1])
    assert ref.max() == 32767              # the content actually clips
    d = np.abs(out[:, :n].astype(np.float64) - ref[:, :n])
    assert d.max() <= 2.0, d.max()


@pytest.mark.parametrize("runs", [(2, 1), (3, 1), (1, 1)])
def test_he_streams_device_splice_matches_numpy_chain(runs):
    """A stream that splices header-led runs of tests/assets/
    dryrun_he.aac: each splice into the run at frame 10 leaves a gap
    between the previous frame's last envelope border and this frame's
    first, so the frame takes slots that no frame patched from the
    carried tail.  The device chain must carry the unpatched buffer there,
    as the numpy SBR chain does."""
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    from ohpipeline_jax.codecs.aac.serving import decode_he_streams_device
    frames = chip_smoke.adts_frames("dryrun_he.aac")
    data = b"".join(f for r in runs for f in frames[10 * r:10 * r + 10])
    got = decode_he_streams_device([data], frames_per_group=8)[0]
    ref = chip_smoke.he_numpy_reference(data)
    assert got.shape == ref.shape == (2, 20 * 2048)
    assert np.abs(got - ref).max() <= chip_smoke.HE_BOUND_LSB
