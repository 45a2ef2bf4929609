"""Opus in MP4 ('Opus' sample entry + 'dOps' box) — the flavour the
reference's CodecOpus decodes (Media/Codec/Opus.cpp:94-98: Opus under
fragmented MPEG/DASH; one packet per MP4 sample, sizes from the moov
tables or per-moof trun).

Ground truth: the same packets through the Ogg path (CodecOpus), whose
decode is conformance-tested against the compiled opus oracle — the MP4
path must produce identical PCM for identical packets.
"""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax.codecs.base import BufferReader
from ohpipeline_jax.codecs.opus import (decode_opus, decode_opus_mp4,
                                        parse_dops)
from ohpipeline_jax.containers.mpeg4 import (find_audio_track, write_m4a,
                                             write_fragmented_m4a)
from ohpipeline_jax.containers.ogg import OggReader

ORACLE = pathlib.Path(__file__).resolve().parent.parent \
    / ".oracle_build" / "opus_oracle"


def _encode_ogg(pcm: np.ndarray, mode: str, bitrate: int) -> bytes:
    ch = pcm.shape[0]
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.ascontiguousarray(pcm.T).tofile(fin)
        subprocess.run([str(ORACLE), "encode", fin, fout, str(ch),
                        str(bitrate), mode], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def _content(seconds: float, ch: int) -> np.ndarray:
    rate = 48000
    t = np.arange(int(rate * seconds)) / rate
    rng = np.random.default_rng(5)
    x = (np.sin(2 * np.pi * 523 * t) * 9000
         + rng.standard_normal(len(t)) * 600)
    x = np.clip(x, -32000, 32000)
    if ch == 2:
        return np.stack([x, np.roll(x, 13)]).astype(np.int16)
    return x[None, :].astype(np.int16)


def _ogg_to_parts(data: bytes):
    """(head, audio packets) from an Ogg Opus stream."""
    from ohpipeline_jax.codecs.opus_headers import parse_opus_head
    packets = list(OggReader(BufferReader(data)).packets())
    head = parse_opus_head(packets[0])
    return head, packets[2:]


def _dops(head) -> bytes:
    return (bytes([0, head.channels])
            + head.pre_skip.to_bytes(2, "big")
            + head.input_rate.to_bytes(4, "big")
            + head.output_gain_q8.to_bytes(2, "big", signed=True)
            + bytes([head.mapping_family]))


def _mux_plain(head, packets) -> bytes:
    return write_m4a(packets, _dops(head), 48000, head.channels,
                     codec="Opus", samples_per_frame=960)


@pytest.mark.parametrize("ch,mode,bitrate", [
    (2, "celt", 96000),
    (1, "silk", 24000),
    (1, "hybrid", 32000),
])
def test_mp4_matches_ogg_decode(ch, mode, bitrate):
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    ogg = _encode_ogg(_content(1.5, ch), mode, bitrate)
    head, packets = _ogg_to_parts(ogg)
    m4a = _mux_plain(head, packets)

    info_o, pcm_ogg = decode_opus(ogg)
    info_m, pcm_mp4 = decode_opus_mp4(m4a)
    assert info_m.sample_rate == 48000
    assert info_m.num_channels == info_o.num_channels
    assert info_m.codec_name == "Opus"
    # identical packets + identical pre-skip -> identical PCM; the two
    # containers may trim the stream end differently (Ogg granule vs
    # mdhd duration) by less than one packet
    n = min(pcm_ogg.shape[1], pcm_mp4.shape[1])
    assert abs(pcm_ogg.shape[1] - pcm_mp4.shape[1]) < 960
    np.testing.assert_array_equal(pcm_ogg[:, :n], pcm_mp4[:, :n])


def test_fragmented_mp4_matches_plain():
    """The moof/trun fragment walk must yield exactly the moov-table
    sample stream (reference re-reads the size table per fragment)."""
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    ogg = _encode_ogg(_content(1.5, 2), "celt", 96000)
    head, packets = _ogg_to_parts(ogg)
    plain = _mux_plain(head, packets)
    frags = [packets[i:i + 7] for i in range(0, len(packets), 7)]
    fmp4 = write_fragmented_m4a(frags, _dops(head), 48000, head.channels,
                                codec="Opus", samples_per_frame=960)

    _, pcm_plain = decode_opus_mp4(plain)
    _, pcm_frag = decode_opus_mp4(fmp4)
    n = min(pcm_plain.shape[1], pcm_frag.shape[1])
    assert abs(pcm_plain.shape[1] - pcm_frag.shape[1]) < 960
    np.testing.assert_array_equal(pcm_plain[:, :n], pcm_frag[:, :n])


def test_dops_parse_and_recognition():
    body = (bytes([0, 2]) + (312).to_bytes(2, "big")
            + (48000).to_bytes(4, "big")
            + (-256).to_bytes(2, "big", signed=True) + bytes([0]))
    head = parse_dops(body)
    assert (head.channels, head.pre_skip, head.input_rate,
            head.output_gain_q8, head.mapping_family) \
        == (2, 312, 48000, -256, 0)

    m4a = write_m4a([b"\xfc\xff\xfe"], body, 48000, 2, codec="Opus",
                    samples_per_frame=960)
    track = find_audio_track(m4a)
    assert track is not None and track.codec == "Opus"
    assert track.codec_config == body

    from ohpipeline_jax.codecs import default_registry
    codec = default_registry.recognise(m4a)
    assert codec is not None and codec.name == "Opus-MP4"
