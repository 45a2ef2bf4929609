"""Ogg Opus header/TOC parse against oracle-encoded real streams."""

import pathlib
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs.base import BufferReader
from ohpipeline_jax.codecs.opus_headers import (packet_samples,
                                                parse_opus_head,
                                                parse_opus_tags, parse_toc)
from ohpipeline_jax.containers.ogg import OggReader

ORACLE = pathlib.Path(__file__).resolve().parent.parent / \
    ".oracle_build" / "opus_oracle"


def test_toc_table():
    # celt fullband 20ms stereo, single frame: config 31 -> toc 0xFC
    t = parse_toc(bytes([31 << 3 | 4]))
    assert (t.mode, t.bandwidth, t.frame_ms) == ("celt", "fb", 20)
    assert t.stereo and t.frames_per_packet == 1
    # silk nb 10ms mono
    t = parse_toc(bytes([0]))
    assert (t.mode, t.bandwidth, t.frame_ms) == ("silk", "nb", 10)
    assert not t.stereo
    assert packet_samples(bytes([31 << 3])) == 960


@pytest.mark.skipif(not ORACLE.exists(), reason="opus oracle not built")
def test_real_stream_headers(tmp_path):
    t = np.arange(9600) / 48000
    pcm = np.rint(np.stack([np.sin(2 * np.pi * 440 * t)] * 2, 1)
                  * 9000).astype(np.int16)
    fin, fopus = tmp_path / "in.raw", tmp_path / "o.opus"
    fin.write_bytes(pcm.tobytes())
    subprocess.run([str(ORACLE), "encode", str(fin), str(fopus), "2"],
                   check=True, capture_output=True)
    pk = OggReader(BufferReader(fopus.read_bytes())).packets()
    head = parse_opus_head(next(pk))
    assert head.version == 1 and head.channels == 2
    assert head.input_rate == 48000 and head.pre_skip > 0
    vendor, _tags = parse_opus_tags(next(pk))
    assert vendor == "oracle"
    audio = next(pk)
    toc = parse_toc(audio)
    assert toc.frame_ms == 20 and packet_samples(audio) == 960
