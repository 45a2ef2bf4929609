"""MPEG-1/2/2.5 Layer III host bitstream parse (headers, side info,
scalefactors, Huffman spectral decode, bit reservoir).

Written from ISO/IEC 11172-3 §2.4 and ISO/IEC 13818-3 §2.4.3.2 (the
low-sampling-frequency extension: one granule per frame, 8-bit
main_data_begin, 9-bit scalefac_compress with partitioned slen, LSF
intensity-stereo positions).  Behavioural parity target: the reference's
libmad adapter (OpenHome/Media/Codec/Mp3.cpp; libmad layer3.c:508-707).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..flac.bitreader import BitReader
from . import tables as T

BITRATES_V1_L3 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                  256, 320)
BITRATES_V2_L3 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
                  160)
RATES_V1 = (44100, 48000, 32000)
RATES_V2 = (22050, 24000, 16000)
RATES_V25 = (11025, 12000, 8000)

# LSF scalefactor band counts per slen partition (ISO/IEC 13818-3
# §2.4.3.2): [compress class][long/short/mixed][partition]
NSFB_LSF = (
    ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
    ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
    ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),
    # intensity-channel variants
    ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)),
    ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)),
    ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)),
)

SLEN = ((0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
        (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3))
PRETAB = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,
                   3, 3, 2, 0], np.int32)

MODE_STEREO, MODE_JOINT, MODE_DUAL, MODE_MONO = range(4)
BLOCK_NORMAL, BLOCK_START, BLOCK_SHORT, BLOCK_STOP = range(4)


class Mp3Error(Exception):
    pass


@dataclass(slots=True)
class FrameHeader:
    version: int          # 1 = MPEG-1, 2 = MPEG-2, 25 = MPEG-2.5
    layer: int            # 3
    bitrate: int
    sample_rate: int
    padding: int
    mode: int
    mode_ext: int
    crc: bool
    frame_bytes: int
    side_bytes: int

    @property
    def lsf(self) -> bool:
        return self.version != 1

    @property
    def granule_count(self) -> int:
        return 1 if self.lsf else 2

    @property
    def samples_per_frame(self) -> int:
        return 576 if self.lsf else 1152

    @property
    def channels(self) -> int:
        return 1 if self.mode == MODE_MONO else 2

    @property
    def ms_stereo(self) -> bool:
        return self.mode == MODE_JOINT and bool(self.mode_ext & 2)

    @property
    def intensity_stereo(self) -> bool:
        return self.mode == MODE_JOINT and bool(self.mode_ext & 1)


def parse_frame_header(data: bytes, pos: int = 0) -> Optional[FrameHeader]:
    if pos + 4 > len(data):
        return None
    b = data[pos:pos + 4]
    if b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
        return None
    version_code = (b[1] >> 3) & 3       # 3 = MPEG1, 2 = MPEG2, 0 = 2.5
    layer_code = (b[1] >> 1) & 3         # 1 = Layer III
    if version_code == 1 or layer_code != 1:
        return None                       # reserved version / not Layer III
    crc = not (b[1] & 1)
    bitrate_idx = (b[2] >> 4) & 0xF
    rate_idx = (b[2] >> 2) & 3
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return None
    padding = (b[2] >> 1) & 1
    mode = (b[3] >> 6) & 3
    mode_ext = (b[3] >> 4) & 3
    if version_code == 3:
        version, rates, brs, spf = 1, RATES_V1, BITRATES_V1_L3, 144
    elif version_code == 2:
        version, rates, brs, spf = 2, RATES_V2, BITRATES_V2_L3, 72
    else:
        version, rates, brs, spf = 25, RATES_V25, BITRATES_V2_L3, 72
    bitrate = brs[bitrate_idx] * 1000
    rate = rates[rate_idx]
    frame_bytes = spf * bitrate // rate + padding
    channels = 1 if mode == MODE_MONO else 2
    if version == 1:
        side = 17 if channels == 1 else 32
    else:
        side = 9 if channels == 1 else 17
    return FrameHeader(version, 3, bitrate, rate, padding, mode, mode_ext,
                       crc, frame_bytes, side)


@dataclass(slots=True)
class GranuleInfo:
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    window_switching: bool = False
    block_type: int = BLOCK_NORMAL
    mixed_block: bool = False
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0
    # decode outputs
    scalefac_l: np.ndarray = None     # (22,)
    scalefac_s: np.ndarray = None     # (13, 3)
    scalefac_lin: np.ndarray = None   # (39,) LSF linear scalefactors
    illegal_lin: np.ndarray = None    # (39,) LSF illegal-intensity flags
    spectrum: np.ndarray = None       # (576,) int32 quantized


@dataclass(slots=True)
class SideInfo:
    main_data_begin: int
    scfsi: list                       # per channel: (4,) flags
    granules: list                    # [gr][ch] -> GranuleInfo


def parse_side_info(br: BitReader, hdr: FrameHeader) -> SideInfo:
    nch = hdr.channels
    lsf = hdr.lsf
    main_data_begin = br.read(8 if lsf else 9)
    if lsf:
        br.read(1 if nch == 1 else 2)  # private bits
        scfsi = [[0] * 4 for _ in range(nch)]
    else:
        br.read(5 if nch == 1 else 3)
        scfsi = [[br.read(1) for _ in range(4)] for _ in range(nch)]
    granules = []
    for _gr in range(hdr.granule_count):
        chans = []
        for _ch in range(nch):
            g = GranuleInfo()
            g.part2_3_length = br.read(12)
            g.big_values = br.read(9)
            g.global_gain = br.read(8)
            g.scalefac_compress = br.read(9 if lsf else 4)
            g.window_switching = bool(br.read(1))
            if g.window_switching:
                g.block_type = br.read(2)
                g.mixed_block = bool(br.read(1))
                g.table_select = (br.read(5), br.read(5), 0)
                g.subblock_gain = (br.read(3), br.read(3), br.read(3))
                if g.block_type == 0:
                    raise Mp3Error("window switching with block_type 0")
                # implicit region split (ISO 2.4.2.7 region_address):
                # region1 covers the whole remainder of the spectrum
                g.region0_count = 8 if g.block_type == BLOCK_SHORT \
                    and not g.mixed_block else 7
                g.region1_count = 36
            else:
                g.table_select = (br.read(5), br.read(5), br.read(5))
                g.region0_count = br.read(4)
                g.region1_count = br.read(3)
            g.preflag = 0 if lsf else br.read(1)
            g.scalefac_scale = br.read(1)
            g.count1table_select = br.read(1)
            chans.append(g)
        granules.append(chans)
    return SideInfo(main_data_begin, scfsi, granules)


def parse_scalefactors(br: BitReader, g: GranuleInfo, gr: int, ch: int,
                       scfsi: list, prev: Optional[GranuleInfo]) -> int:
    """Returns part2 bit count consumed."""
    slen1, slen2 = SLEN[g.scalefac_compress]
    bits = 0
    if g.window_switching and g.block_type == BLOCK_SHORT:
        g.scalefac_s = np.zeros((13, 3), np.int32)
        if g.mixed_block:
            g.scalefac_l = np.zeros(22, np.int32)
            for sfb in range(8):
                g.scalefac_l[sfb] = br.read(slen1)
                bits += slen1
            for sfb in range(3, 6):
                for w in range(3):
                    g.scalefac_s[sfb, w] = br.read(slen1)
                    bits += slen1
        else:
            g.scalefac_l = np.zeros(22, np.int32)
            for sfb in range(6):
                for w in range(3):
                    g.scalefac_s[sfb, w] = br.read(slen1)
                    bits += slen1
        for sfb in range(6, 12):
            for w in range(3):
                g.scalefac_s[sfb, w] = br.read(slen2)
                bits += slen2
    else:
        g.scalefac_l = np.zeros(22, np.int32)
        g.scalefac_s = np.zeros((13, 3), np.int32)
        groups = ((0, 6, slen1), (6, 11, slen1), (11, 16, slen2),
                  (16, 21, slen2))
        for gi, (a, b, slen) in enumerate(groups):
            if gr == 1 and scfsi[ch][gi] and prev is not None:
                g.scalefac_l[a:b] = prev.scalefac_l[a:b]
            else:
                for sfb in range(a, b):
                    g.scalefac_l[sfb] = br.read(slen)
                    bits += slen
    return bits


def parse_scalefactors_lsf(br: BitReader, g: GranuleInfo,
                           intensity_ch: bool) -> int:
    """LSF scalefactor decode (ISO 13818-3 §2.4.3.2): the 9-bit
    scalefac_compress selects slen[0..3] and a band-count partition;
    values land in a linear 39-entry array matching the sfb-width walk.
    For the right channel under intensity stereo, values are is-positions
    and the all-ones value per slen flags an illegal position.
    Returns the part2 bit count."""
    sc = g.scalefac_compress
    index = 0
    if g.window_switching and g.block_type == BLOCK_SHORT:
        index = 2 if g.mixed_block else 1
    if not intensity_ch:
        if sc < 400:
            slen = ((sc >> 4) // 5, (sc >> 4) % 5, (sc % 16) >> 2, sc % 4)
            nsfb = NSFB_LSF[0][index]
        elif sc < 500:
            sc -= 400
            slen = ((sc >> 2) // 5, (sc >> 2) % 5, sc % 4, 0)
            nsfb = NSFB_LSF[1][index]
        else:
            sc -= 500
            slen = (sc // 3, sc % 3, 0, 0)
            g.preflag = 1
            nsfb = NSFB_LSF[2][index]
    else:
        sc >>= 1
        if sc < 180:
            slen = (sc // 36, (sc % 36) // 6, (sc % 36) % 6, 0)
            nsfb = NSFB_LSF[3][index]
        elif sc < 244:
            sc -= 180
            slen = ((sc % 64) >> 4, (sc % 16) >> 2, sc % 4, 0)
            nsfb = NSFB_LSF[4][index]
        else:
            sc -= 244
            slen = (sc // 3, sc % 3, 0, 0)
            nsfb = NSFB_LSF[5][index]
    lin = np.zeros(39, np.int32)
    ill = np.zeros(39, np.int32)
    bits = 0
    n = 0
    for part in range(4):
        s = slen[part]
        mx = (1 << s) - 1
        for _ in range(nsfb[part]):
            v = br.read(s) if s else 0
            lin[n] = v
            if intensity_ch:
                ill[n] = int(v == mx)
            n += 1
        bits += s * nsfb[part]
    g.scalefac_lin = lin
    g.illegal_lin = ill
    # structured views for the shared long-block stereo path
    if not (g.window_switching and g.block_type == BLOCK_SHORT):
        g.scalefac_l = np.zeros(22, np.int32)
        g.scalefac_l[:22] = lin[:22]
        g.scalefac_s = np.zeros((13, 3), np.int32)
    else:
        g.scalefac_l = np.zeros(22, np.int32)
        g.scalefac_s = np.zeros((13, 3), np.int32)
    return bits


def _long_widths(rate: int) -> np.ndarray:
    return T.sfb_long(rate)


def parse_huffman(br: BitReader, g: GranuleInfo, hdr: FrameHeader,
                  part2_bits: int) -> None:
    """Decode big_values pairs + count1 quads into g.spectrum (576,)."""
    out = np.zeros(576, np.int32)
    end_bit = br.pos + (g.part2_3_length - part2_bits)
    # region boundaries: counted in bands of the applicable sfb-width
    # table (interleaved for short blocks), per ISO 2.4.2.7 / libmad
    # layer3.c III_huffdecode's sfbwidth walk
    if g.window_switching and g.block_type == BLOCK_SHORT:
        widths = T.sfb_mixed(hdr.sample_rate) if g.mixed_block \
            else T.sfb_short_interleaved(hdr.sample_rate)
    else:
        widths = _long_widths(hdr.sample_rate)
    offsets = np.concatenate([[0], np.cumsum(widths)])
    r0 = min(g.region0_count + 1, len(offsets) - 1)
    r1 = min(g.region0_count + 1 + g.region1_count + 1,
             len(offsets) - 1)
    region1 = int(offsets[r0])
    region2 = int(offsets[r1])
    big = min(g.big_values * 2, 576)
    from ohpipeline_jax import native as _nat
    if _nat.have_mp3_core():
        g.spectrum, br.pos = _nat.mp3_parse_huffman(
            br.data, br.pos, end_bit, big, region1, region2,
            tuple(g.table_select), g.count1table_select)
        return
    i = 0
    while i < big:
        if i < region1:
            tid = g.table_select[0]
        elif i < region2:
            tid = g.table_select[1]
        else:
            tid = g.table_select[2]
        lut = T.PAIR_LUTS.get(tid)
        if lut is None:                  # table 0: all zeros
            i += 2
            continue
        if br.pos >= end_bit:
            break
        xy = lut.decode(br)
        x, y = int(xy[0]), int(xy[1])
        linbits = T.PAIR_LINBITS[tid]
        if x == 15 and linbits:
            x += br.read(linbits)
        if x and br.read(1):
            x = -x
        if y == 15 and linbits:
            y += br.read(linbits)
        if y and br.read(1):
            y = -y
        out[i] = x
        out[i + 1] = y
        i += 2
    # count1: quads until bits exhausted
    lut1 = T.QUAD_LUTS[g.count1table_select]
    while br.pos < end_bit and i <= 572:
        vals = [int(v) for v in lut1.decode(br)]
        for j in range(4):
            if vals[j] and br.read(1):
                vals[j] = -vals[j]
            if i < 576:
                out[i] = vals[j]
            i += 1
    if br.pos > end_bit:
        # overread inside the last quad: zero it (libmad does the same)
        out[max(0, i - 4):i] = 0
    br.pos = end_bit
    g.spectrum = out


@dataclass(slots=True)
class Mp3Frame:
    header: FrameHeader
    side: SideInfo


class Mp3Stream:
    """Frame walker with bit-reservoir handling: frames reference up to
    511 bytes of previous frames' main_data (main_data_begin)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                     # byte offset of next frame
        self._reservoir = b""

    def next_frame(self) -> Optional[Mp3Frame]:
        data = self.data
        while True:
            hdr = parse_frame_header(data, self.pos)
            if hdr is not None and self.pos + hdr.frame_bytes <= len(data):
                break
            if hdr is not None:
                return None              # incomplete tail frame
            nxt = data.find(b"\xff", self.pos + 1)
            if nxt == -1:
                return None
            self.pos = nxt
        start = self.pos
        br = BitReader(data, (start + 4 + (2 if hdr.crc else 0)) * 8)
        try:
            side = parse_side_info(br, hdr)
        except (EOFError, Mp3Error):
            self.pos = start + 1
            return self.next_frame()
        main_start = start + 4 + (2 if hdr.crc else 0) + hdr.side_bytes
        this_main = data[main_start:start + hdr.frame_bytes]
        # bit reservoir: main_data begins main_data_begin bytes back
        if side.main_data_begin > len(self._reservoir):
            # not enough history (stream start / after seek): skip frame
            self._reservoir = (self._reservoir + this_main)[-511:]
            self.pos = start + hdr.frame_bytes
            return Mp3Frame(hdr, None)   # undecodable frame (no main data)
        main_data = (self._reservoir[len(self._reservoir)
                                     - side.main_data_begin:]
                     if side.main_data_begin else b"") + this_main
        mbr = BitReader(main_data)
        nch = hdr.channels
        try:
            for gr in range(hdr.granule_count):
                for ch in range(nch):
                    g = side.granules[gr][ch]
                    if hdr.lsf:
                        p2 = parse_scalefactors_lsf(
                            mbr, g, ch == 1 and hdr.intensity_stereo)
                    else:
                        prev = side.granules[0][ch] if gr == 1 else None
                        p2 = parse_scalefactors(mbr, g, gr, ch, side.scfsi,
                                                prev)
                    parse_huffman(mbr, g, hdr, p2)
        except (EOFError, ValueError):
            side = None
        self._reservoir = (self._reservoir + this_main)[-511:]
        self.pos = start + hdr.frame_bytes
        return Mp3Frame(hdr, side)
