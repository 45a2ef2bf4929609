"""Container-layer tests: ID3v2 strip/tags, Ogg paging, MP4 sample tables,
MPEG-TS demux (reference Media/Tests/TestContainer.cpp style)."""

import struct

import numpy as np
import pytest

from ohpipeline_jax.codecs.base import BufferReader
from ohpipeline_jax.containers import (ContainerController, OggReader,
                                       default_containers, id3v2, ogg)
from ohpipeline_jax.containers import mpeg4, mpegts


def make_id3(frames: dict, version=4) -> bytes:
    body = b""
    for fid, text in frames.items():
        payload = b"\x03" + text.encode() + b"\x00"
        size = (id3v2._syncsafe.__wrapped__(len(payload))
                if hasattr(id3v2._syncsafe, "__wrapped__") else None)
        # syncsafe encode
        n = len(payload)
        enc = bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F,
                     (n >> 7) & 0x7F, n & 0x7F])
        body += fid.encode() + enc + b"\x00\x00" + payload
    n = len(body)
    hdr = b"ID3" + bytes([version, 0, 0]) + bytes(
        [(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])
    return hdr + body


class TestId3v2:
    def test_parse_and_strip(self):
        tag = make_id3({"TIT2": "Song", "TPE1": "Artist"})
        payload = b"AUDIO_DATA" * 10
        size, meta = id3v2.parse_id3v2(tag + payload)
        assert size == len(tag)
        assert meta == {"title": "Song", "artist": "Artist"}
        c = id3v2.ContainerId3v2()
        assert c.recognise(tag + payload)
        r = c.wrap(BufferReader(tag + payload))
        assert r.read(10) == b"AUDIO_DATA"

    def test_controller_chains_to_flac(self):
        from ohpipeline_jax.codecs import flac
        t = np.arange(4410) / 44100
        tone = np.tile(np.rint(np.sin(2 * np.pi * 1000 * t) * 20000)
                       .astype(np.int32), (2, 1))
        data = make_id3({"TIT2": "X"}) + flac.encode_flac(tone, 44100, 16)
        cc = ContainerController(default_containers())
        reader, meta = cc.process(BufferReader(data))
        assert meta["title"] == "X"
        assert reader.peek(4) == b"fLaC"


class TestOgg:
    def test_page_roundtrip(self):
        pkts = [b"hello", b"x" * 600, b"tail"]
        page = ogg.build_page(7, 0, 1234, pkts, header_type=2)
        parsed, nxt = ogg.parse_page(page)
        assert nxt == len(page)
        assert parsed.serial == 7 and parsed.bos
        assert parsed.segments == pkts

    def test_packet_reassembly_across_pages(self):
        big = bytes(range(256)) * 300   # 76800 bytes -> spans 2+ pages
        small = b"small"
        stream = ogg.build_pages(7, [big, small], bos=True, eos=True,
                                 granule=100)
        assert stream.count(b"OggS") >= 2
        r = OggReader(BufferReader(stream))
        got = list(r.packets())
        assert got == [big, small]

    def test_reader_skips_other_serials(self):
        pa = ogg.build_page(1, 0, 0, [b"a"], header_type=2)
        pb = ogg.build_page(2, 0, 0, [b"b"])
        r = OggReader(BufferReader(pa + pb))
        assert list(r.packets()) == [b"a"]


class TestMpeg4:
    def _make_minimal_mp4(self):
        # hand-build moov with one mp4a track, 3 samples in 2 chunks
        def box(t, body):
            return struct.pack(">I4s", len(body) + 8, t) + body

        asc = b"\x12\x10"                      # AAC-LC 44.1k stereo
        dsi = bytes([0x05, len(asc)]) + asc
        dcd = (bytes([0x04, 13 + len(dsi), 0x40, 0x15])
               + b"\x00" * 11 + dsi)
        esd = bytes([0x03, 3 + len(dcd)]) + b"\x00\x00\x00" + dcd
        esds = box(b"esds", b"\x00\x00\x00\x00" + esd)
        mp4a = box(b"mp4a", b"\x00" * 6 + b"\x00\x01"
                   + b"\x00" * 8 + struct.pack(">HH", 2, 16)
                   + b"\x00" * 4 + struct.pack(">HH", 44100, 0) + esds)
        stsd = box(b"stsd", b"\x00\x00\x00\x00\x00\x00\x00\x01" + mp4a)
        stts = box(b"stts", struct.pack(">IIII", 0, 1, 3, 1024))
        stsc = box(b"stsc", struct.pack(">IIIII", 0, 1, 1, 2, 1))
        stsz = box(b"stsz", struct.pack(">IIIIII", 0, 0, 3, 10, 20, 30))
        stco = box(b"stco", struct.pack(">IIII", 0, 2, 1000, 2000))
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        mdhd = box(b"mdhd", struct.pack(">IIIII", 0, 0, 0, 44100, 3072)
                   + b"\x00\x00\x00\x00")
        mdia = box(b"mdia", mdhd + box(b"minf", stbl))
        trak = box(b"trak", mdia)
        moov = box(b"moov", trak)
        ftyp = box(b"ftyp", b"M4A \x00\x00\x00\x00")
        return ftyp + moov

    def test_parse_track(self):
        data = self._make_minimal_mp4()
        tr = mpeg4.find_audio_track(data)
        assert tr is not None
        assert tr.codec == "mp4a"
        assert (tr.channels, tr.bits, tr.sample_rate) == (2, 16, 44100)
        assert tr.codec_config == b"\x12\x10"       # ASC: AAC-LC 44.1k stereo
        assert tr.sample_sizes == [10, 20, 30]
        offsets = list(tr.sample_offsets())
        assert offsets == [(1000, 10), (1000 + 10, 20), (2000, 30)]
        assert tr.total_samples == 3
        idx, pcm0 = tr.seek_sample(2048)
        assert idx == 2 and pcm0 == 2048

    def test_recognise(self):
        c = mpeg4.ContainerMpeg4()
        assert c.recognise(self._make_minimal_mp4()[:16])
        assert not c.recognise(b"\x00" * 16)


class TestMpegTs:
    def _ts_packet(self, pid, payload, pusi=False, counter=0):
        hdr = bytes([mpegts.SYNC,
                     (0x40 if pusi else 0) | (pid >> 8), pid & 0xFF,
                     0x10 | (counter & 0xF)])
        pkt = hdr + payload
        return pkt + b"\xff" * (188 - len(pkt))

    def test_pat_pmt_audio_extraction(self):
        # PAT: program 1 -> PMT pid 0x100
        pat_sec = bytes([0x00, 0xB0, 0x0D, 0, 1, 0xC1, 0, 0,
                         0x00, 0x01, 0xE1, 0x00]) + b"\x00" * 4
        pat = self._ts_packet(0, b"\x00" + pat_sec, pusi=True)
        # PMT: stream_type 0x0F (ADTS AAC) on pid 0x101
        pmt_sec = bytes([0x02, 0xB0, 0x12, 0, 1, 0xC1, 0, 0,
                         0xE1, 0x01, 0xF0, 0x00,
                         0x0F, 0xE1, 0x01, 0xF0, 0x00]) + b"\x00" * 4
        pmt = self._ts_packet(0x100, b"\x00" + pmt_sec, pusi=True)
        pes_hdr = b"\x00\x00\x01\xC0\x00\x00\x80\x00\x00"
        audio = self._ts_packet(0x101, pes_hdr + b"AUDIOBYTES", pusi=True)
        r = mpegts._TsReader(BufferReader(pat + pmt + audio))
        out = r.read(10)
        assert out == b"AUDIOBYTES"
        assert r._demux.audio_type == "aac_adts"

    def test_recognise(self):
        c = mpegts.ContainerMpegTs()
        data = self._ts_packet(0, b"x") + self._ts_packet(0, b"y")
        assert c.recognise(data)
        assert not c.recognise(b"\x00" * 400)
