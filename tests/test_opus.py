"""Ogg Opus end-to-end conformance vs the reference oracle
(tools/opus_oracle.c): decoded PCM within 1-2 LSB, exact sample counts
(pre-skip + final-page granule trim), registry recognition, SILK gating,
and playback through the full pipeline."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import codecs
from ohpipeline_jax.codecs import CodecStreamCorrupt
from ohpipeline_jax.codecs.opus import decode_opus, split_packet_frames

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "opus_oracle")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="opus oracle not built")


def _make(channels=2, seconds=3.0, bitrate=128000, seed=2, quiet=False):
    rate = 48000
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    amp = 0.02 if quiet else 0.4
    x = amp * np.sin(2 * np.pi * 500 * t) \
        + amp / 8 * rng.standard_normal(n)
    pcm = np.stack([x, np.roll(x, 9)])[:channels]
    p16 = np.clip(np.rint(pcm * 20000), -32768, 32767).astype(np.int16)
    td = tempfile.mkdtemp()
    raw = os.path.join(td, "in.raw")
    opus = os.path.join(td, "a.opus")
    dec = os.path.join(td, "d.raw")
    np.ascontiguousarray(p16.T).tofile(raw)
    subprocess.run([ORACLE, "encode", raw, opus, str(channels),
                    str(bitrate)], check=True, capture_output=True)
    subprocess.run([ORACLE, "decode", opus, dec], check=True,
                   capture_output=True)
    ref = np.fromfile(dec, np.int16).reshape(-1, channels).T
    return open(opus, "rb").read(), ref


@pytest.mark.parametrize("channels,bitrate", [(2, 128000), (2, 64000),
                                              (1, 96000)])
def test_decode_matches_oracle(channels, bitrate):
    data, ref = _make(channels=channels, bitrate=bitrate)
    info, got = decode_opus(data)
    assert info.sample_rate == 48000
    assert info.num_channels == channels
    # exact length: pre-skip applied + final granule trim
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2


def test_registry_recognises_opus_over_vorbis():
    data, _ = _make(seconds=1.0)
    codec = codecs.default_registry.recognise(data[:128])
    assert codec is not None and codec.name == "Opus"


def test_packet_frame_splitting():
    # code 0
    toc0 = bytes([0xF8 | 0]) + b"abcd"            # celt fb 20ms, code 0
    t, f = split_packet_frames(toc0)
    assert t.mode == "celt" and f == [b"abcd"]
    # code 1: two equal frames
    toc1 = bytes([0xF8 | 1]) + b"abcdef"
    _, f = split_packet_frames(toc1)
    assert f == [b"abc", b"def"]
    # code 3 CBR: 3 frames
    toc3 = bytes([0xF8 | 3, 3]) + b"abcdef"
    _, f = split_packet_frames(toc3)
    assert f == [b"ab", b"cd", b"ef"]


def test_malformed_packets_raise():
    from ohpipeline_jax.codecs.opus import _OpusStream
    from ohpipeline_jax.codecs.opus_headers import OpusHead
    st = _OpusStream(OpusHead(1, 1, 0, 48000, 0, 0))
    with pytest.raises(CodecStreamCorrupt):
        st.decode_packet(b"")
    with pytest.raises(CodecStreamCorrupt):          # odd code-1 body
        st.decode_packet(bytes([0xF8 | 1]) + b"abc")


def test_plays_through_pipeline(tmp_path):
    from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    data, ref = _make(seconds=2.0)
    path = tmp_path / "t.opus"
    path.write_bytes(data)
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    mgr = PipelineManager(params)
    chunks = []
    mgr.play_uri(f"file://{path}")
    animator = AnimatorBatch(mgr.pipeline.predriver,
                             lambda s, i: chunks.append((s, i)),
                             use_device=False)
    animator.run()
    mgr.quit()
    assert chunks, "no audio reached the sink"
    assert chunks[0][1].codec_name == "Opus"
    pcm = np.concatenate([c for c, _ in chunks], axis=1)
    m = min(pcm.shape[1], ref.shape[1])
    assert m > 40000
    assert np.abs(pcm[:, :m].astype(int)
                  - ref[:, :m].astype(int)).max() <= 2


def test_random_packet_fuzz_no_leaked_exceptions():
    """Arbitrary bytes through the packet layer must either decode
    (range-coder concealment, like libopus) or raise
    CodecStreamCorrupt — never IndexError/ValueError from the frame
    splitting (RFC 6716 s3.2 bounds)."""
    from ohpipeline_jax.codecs.opus import _OpusStream
    from ohpipeline_jax.codecs.opus_headers import OpusHead
    rng = np.random.default_rng(0)
    st = _OpusStream(OpusHead(1, 2, 0, 48000, 0, 0))
    decoded = corrupt = 0
    for _ in range(600):
        n = int(rng.integers(1, 160))
        pkt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        try:
            st.decode_packet(pkt)
            decoded += 1
        except CodecStreamCorrupt:
            corrupt += 1
    assert decoded + corrupt == 600
    assert decoded > 0 and corrupt > 0
