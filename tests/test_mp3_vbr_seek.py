"""MP3 Xing/Info/VBRI VBR header parsing, duration and TOC-based seek
(reference Mp3.cpp duration/seek handling)."""

import numpy as np
import pytest

from ohpipeline_jax.codecs.base import BufferReader
from ohpipeline_jax.codecs.mp3 import CodecMp3, parse_vbr_header
from ohpipeline_jax.codecs.mp3 import bitstream as BS
from ohpipeline_jax.codecs.mp3 import encoder as ENC


def _cbr_stream(seconds=2.0, rate=44100):
    nframes = max(4, int(seconds * rate / 1152))
    spec = [ENC.tone_spectrum(12), ENC.tone_spectrum(20)]
    return ENC.build_stream(spec, nframes=nframes, global_gain=178)


def _with_xing(data: bytes, toc=None) -> bytes:
    """Prepend a crafted Xing frame matching the stream's first header."""
    hdr = BS.parse_frame_header(data)
    frames = 0
    pos = 0
    while True:
        h = BS.parse_frame_header(data, pos)
        if h is None or pos + h.frame_bytes > len(data):
            break
        frames += 1
        pos += h.frame_bytes
    frame = bytearray(data[:hdr.frame_bytes])
    side = 32 if (hdr.version == 1 and hdr.channels == 2) else (
        17 if hdr.version == 1 or hdr.channels == 2 else 9)
    off = 4 + side
    frame[off:off + 4] = b"Xing"
    p = off + 4
    flags = 1 | 2 | (4 if toc is not None else 0)
    frame[p:p + 4] = flags.to_bytes(4, "big")
    p += 4
    frame[p:p + 4] = frames.to_bytes(4, "big")
    p += 4
    nbytes = hdr.frame_bytes + len(data)
    frame[p:p + 4] = nbytes.to_bytes(4, "big")
    p += 4
    if toc is not None:
        frame[p:p + 100] = bytes(toc)
    return bytes(frame) + data


def test_xing_parse_and_duration():
    data = _cbr_stream()
    hdr = BS.parse_frame_header(data)
    toc = [min(255, int(i * 2.56)) for i in range(100)]   # linear map
    full = _with_xing(data, toc)
    vbr = parse_vbr_header(full, hdr)
    assert vbr is not None
    assert vbr["bytes"] == len(full)
    assert vbr["toc"] is not None and len(vbr["toc"]) == 100
    codec = CodecMp3()
    info = codec.stream_initialise(BufferReader(full))
    # duration from the Xing frame count, not the raw byte estimate
    expect = vbr["frames"] * hdr.samples_per_frame
    got = info.track_length_jiffies // \
        __import__("ohpipeline_jax.core.jiffies",
                   fromlist=["Jiffies"]).Jiffies.per_sample(hdr.sample_rate)
    assert got == expect


def test_xing_toc_seek_interpolates():
    data = _cbr_stream()
    hdr = BS.parse_frame_header(data)
    # a deliberately NON-linear TOC: first half of time in first 25% of
    # bytes (as a VBR file would have)
    toc = [min(255, int((i / 100) ** 2 * 256)) for i in range(100)]
    full = _with_xing(data, toc)
    codec = CodecMp3()
    codec.stream_initialise(BufferReader(full))
    total_samples = codec._vbr["frames"] * hdr.samples_per_frame
    b_mid = codec.try_seek(total_samples // 2)
    # CBR estimate would be ~50% of bytes; the TOC maps 50% time -> 25%
    assert b_mid < 0.3 * len(full)
    b_75 = codec.try_seek(3 * total_samples // 4)
    assert 0.5 * len(full) < b_75 < 0.62 * len(full)
    assert codec.try_seek(0) == 0


def test_xing_frame_not_decoded_as_audio():
    data = _cbr_stream(seconds=0.5)
    full = _with_xing(data)
    from ohpipeline_jax.codecs.mp3 import decode_mp3
    _, pcm_plain = decode_mp3(data)
    _, pcm_xing = decode_mp3(full)
    # same frame count: the Xing frame was skipped, not decoded
    assert pcm_xing.shape == pcm_plain.shape
    np.testing.assert_array_equal(pcm_xing, pcm_plain)


def test_vbri_parse():
    data = _cbr_stream(seconds=0.5)
    hdr = BS.parse_frame_header(data)
    frame = bytearray(data[:hdr.frame_bytes])
    frame[36:40] = b"VBRI"
    p = 40
    frame[p:p + 2] = (1).to_bytes(2, "big")       # version
    frame[p + 2:p + 4] = (0).to_bytes(2, "big")   # delay
    frame[p + 4:p + 6] = (50).to_bytes(2, "big")  # quality
    nbytes = len(data)
    frame[p + 6:p + 10] = nbytes.to_bytes(4, "big")
    frame[p + 10:p + 14] = (19).to_bytes(4, "big")  # frames
    frame[p + 14:p + 16] = (4).to_bytes(2, "big")   # entries
    frame[p + 16:p + 18] = (1).to_bytes(2, "big")   # scale
    frame[p + 18:p + 20] = (2).to_bytes(2, "big")   # entry bytes
    frame[p + 20:p + 22] = (5).to_bytes(2, "big")   # frames/entry
    q = p + 22
    for v in (nbytes // 4,) * 4:
        frame[q:q + 2] = v.to_bytes(2, "big")
        q += 2
    vbr = parse_vbr_header(bytes(frame), hdr)
    assert vbr is not None
    assert vbr["frames"] == 19 and vbr["bytes"] == nbytes
    assert vbr["toc"] is not None
    assert 0.45 < vbr["toc"][50] < 0.55
