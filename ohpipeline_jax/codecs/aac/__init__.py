"""AAC-LC codec: ADTS and MP4 front-ends, host entropy decode + batched
device filterbank.

Parity target: the reference's fdk-aac adapters
(OpenHome/Media/Codec/AacFdkAdts.cpp, AacFdkMp4.cpp -> libAACdec) for
AAC-LC.  Accuracy: float32 filterbank vs fdk's fixed-point — validated
against the compiled fdk oracle within tight RMS bounds (the ISO
conformance criterion; transform coding is not bit-unique across
implementations).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from ...core.jiffies import Jiffies
from ...core.streaminfo import PcmStreamInfo
from ..base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                    StreamReader)
from ..flac.bitreader import BitReader
from . import bitstream as BS
from . import synthesis as SYN
from . import tables as T

GROUP_FRAMES = 32
# HE-AAC groups are larger: the SBR device program scans over frames, so
# program size is F-independent, and fewer dispatch+fetch round trips
# leave less fixed per-call latency
SBR_GROUP_FRAMES = 96


class _StreamState:
    """Carries filterbank overlap + window shape across process() calls."""

    def __init__(self, channels: int):
        self.prev_shape = np.zeros(channels, np.int32)
        self.overlap = np.zeros((channels, 1024), np.float32)
        self.op_bank = SYN.operator_bank()


def decode_frames(frames: list[BS.FrameData], state: _StreamState,
                  bit_depth: int = 16) -> np.ndarray:
    """Decode parsed frames -> (channels, T*1024) int32 native range."""
    if not frames:
        return np.zeros((len(state.prev_shape), 0), np.int32)
    nch = len(frames[0].channels)
    Tf = len(frames)
    specs = np.zeros((Tf, nch, 1024), np.float32)
    opidx = np.zeros((Tf, nch), np.int32)
    for t, frame in enumerate(frames):
        chs = frame.channels
        sp = [SYN.dequantize(ch, frame.rate_index) for ch in chs]
        SYN.apply_spectral_tools(frame, sp)
        for ci, ch in enumerate(chs):
            SYN.apply_tns(ch, sp[ci], frame.rate_index)
            mode = ch.ics.window_sequence
            opidx[t, ci] = (mode * 4 + int(state.prev_shape[ci]) * 2
                            + ch.ics.window_shape)
            state.prev_shape[ci] = ch.ics.window_shape
            specs[t, ci] = sp[ci]
    A, B = state.op_bank
    pcm, new_ov = SYN.filterbank(jnp.asarray(specs), jnp.asarray(opidx),
                                 jnp.asarray(state.overlap),
                                 jnp.asarray(A), jnp.asarray(B))
    state.overlap = np.asarray(new_ov)
    out = np.asarray(pcm)                       # (Tf, nch, 1024)
    out = out.transpose(1, 0, 2).reshape(nch, -1)
    lo, hi = -(1 << (bit_depth - 1)), (1 << (bit_depth - 1)) - 1
    return np.clip(np.rint(out), lo, hi).astype(np.int32)


def decode_frames_float(frames: list[BS.FrameData],
                        state: _StreamState) -> np.ndarray:
    """decode_frames without the final integer clip — the float core
    signal the SBR upsampler consumes (float64 (C, T*1024))."""
    if not frames:
        return np.zeros((len(state.prev_shape), 0))
    nch = len(frames[0].channels)
    W, SW = SYN.window_bank()
    ML = SYN._imdct_matrix(2048).astype(np.float64)
    MS = SYN._imdct_matrix(256).astype(np.float64)
    if state.overlap is None or np.ndim(state.overlap) != 2:
        state.overlap = np.zeros((nch, 1024))
    out = np.zeros((nch, len(frames) * 1024))
    for t, frame in enumerate(frames):
        chs = frame.channels
        sp = [SYN.dequantize(ch, frame.rate_index) for ch in chs]
        SYN.apply_spectral_tools(frame, sp)
        for ci, ch in enumerate(chs):
            SYN.apply_tns(ch, sp[ci], frame.rate_index)
            mode = ch.ics.window_sequence
            opidx = (mode * 4 + int(state.prev_shape[ci]) * 2
                     + ch.ics.window_shape)
            state.prev_shape[ci] = ch.ics.window_shape
            if mode == BS.EIGHT_SHORT:
                xs = sp[ci].reshape(8, 128) @ MS * SW[opidx & 3]
                x = np.zeros(2048)
                for w in range(8):
                    x[448 + w * 128:448 + w * 128 + 256] += xs[w]
            else:
                x = sp[ci] @ ML * W[opidx]
            out[ci, t * 1024:(t + 1) * 1024] = x[:1024] \
                + state.overlap[ci]
            state.overlap[ci] = x[1024:]
    return out


def group_specs_from_frames(frames: list[BS.FrameData],
                            state: _StreamState) -> tuple:
    """Prepared spectra + operator indices for a group of parsed frames
    (host dequant/TNS only — the IMDCT runs wherever the caller wants
    it).  Returns (specs (F, C, 1024) f32, ops (F, C) i32); advances
    state.prev_shape."""
    nch = len(frames[0].channels)
    F = len(frames)
    specs = np.zeros((F, nch, 1024), np.float32)
    ops = np.zeros((F, nch), np.int32)
    for t, frame in enumerate(frames):
        chs = frame.channels
        sp = [SYN.dequantize(ch, frame.rate_index) for ch in chs]
        SYN.apply_spectral_tools(frame, sp)
        for ci, ch in enumerate(chs):
            SYN.apply_tns(ch, sp[ci], frame.rate_index)
            mode = ch.ics.window_sequence
            ops[t, ci] = (mode * 4 + int(state.prev_shape[ci]) * 2
                          + ch.ics.window_shape)
            state.prev_shape[ci] = ch.ics.window_shape
            specs[t, ci] = sp[ci]
    return specs, ops


def decode_frames_float_batched(frames: list[BS.FrameData],
                                state: _StreamState) -> np.ndarray:
    """decode_frames_float with the whole group's IMDCT as one float32
    numpy matmul (the per-frame float64 path costs ~8x more memory
    traffic; the SBR chain consuming this is float32 anyway).  Same
    state contract as decode_frames_float."""
    if not frames:
        return np.zeros((len(state.prev_shape), 0))
    specs, ops = group_specs_from_frames(frames, state)
    return _core_float_from_specs(specs, ops, state)


def _core_float_from_specs(specs: np.ndarray, ops: np.ndarray,
                           state: _StreamState) -> np.ndarray:
    """Batched float32 IMDCT + window + overlap-add from prepared
    spectra: specs (F, C, 1024) f32, ops (F, C) i32 operator indices.
    Updates state.overlap; returns float64 (C, F*1024)."""
    F, nch = specs.shape[:2]
    W, SW = SYN.window_bank()
    ML = SYN._imdct_matrix(2048).astype(np.float32)
    MS = SYN._imdct_matrix(256).astype(np.float32)
    if state.overlap is None or np.ndim(state.overlap) != 2:
        state.overlap = np.zeros((nch, 1024))
    flat = specs.reshape(F * nch, 1024)
    x_long = (flat @ ML) * W[ops.reshape(-1)].astype(np.float32)
    is_short = (ops.reshape(-1) >> 2) == BS.EIGHT_SHORT
    if is_short.any():
        xs = np.einsum("rwk,kn->rwn",
                       flat.reshape(-1, 8, 128), MS)             * SW[ops.reshape(-1) & 3].astype(np.float32)
        x_short = np.zeros((F * nch, 2048), np.float32)
        for w in range(8):
            x_short[:, 448 + w * 128:448 + w * 128 + 256] += xs[:, w]
        x_long = np.where(is_short[:, None], x_short, x_long)
    x = x_long.reshape(F, nch, 2048).astype(np.float64)
    out = np.zeros((nch, F * 1024))
    for t in range(F):
        out[:, t * 1024:(t + 1) * 1024] = x[t, :, :1024] + state.overlap
        state.overlap = x[t, :, 1024:]
    return out


def decode_group_arrays(batch: dict, nframes: int, channels: int,
                        state: _StreamState,
                        bit_depth: int = 16) -> np.ndarray:
    """Array-native decode: vectorized spectral prep feeding the batched
    device filterbank.  Same result as decode_frames over rehydrated
    objects, at bench throughput."""
    specs, opidx = SYN.prepare_group(batch, nframes, channels,
                                     state.prev_shape)
    W, SW = SYN.window_bank()
    pcm, new_ov = SYN.filterbank_fast(
        jnp.asarray(specs), jnp.asarray(opidx), jnp.asarray(state.overlap),
        jnp.asarray(SYN._imdct_matrix(2048)),
        jnp.asarray(SYN._imdct_matrix(256)),
        jnp.asarray(W), jnp.asarray(SW))
    state.overlap = np.asarray(new_ov)
    out = np.asarray(pcm).transpose(1, 0, 2).reshape(channels, -1)
    lo, hi = -(1 << (bit_depth - 1)), (1 << (bit_depth - 1)) - 1
    return np.clip(np.rint(out), lo, hi).astype(np.int32)


NCFG = 4
MAX_SIDE = 16


def prepare_device_group(batch: dict, nframes: int, channels: int,
                         prev_shape: np.ndarray,
                         cfg_map: Optional[dict] = None
                         ) -> Optional[dict]:
    """Assemble the numpy inputs of SYN.dequant_filterbank for one parsed
    group (shared cfg_map lets callers batch multiple streams into one
    dispatch).  Returns None when the group doesn't fit the fast path."""
    ri = batch["rate_index"]
    F, C = nframes, channels
    R = F * C
    if R == 0 or C != 2:
        return None
    if cfg_map is None:
        cfg_map = {}
    ics = batch["ics"][:R]
    cb = batch["cb"][:R]
    sf = batch["sf"][:R]
    quant = batch["quant"][:R]
    # layout configs (cfg_map is shared across streams by callers that
    # stack several parses into one dispatch — do not rebind it)
    cfg_idx = np.zeros(R, np.int32)
    for r in range(R):
        seq = int(ics[r][0])
        short = seq == BS.EIGHT_SHORT
        key = (ri, seq if short else 0, int(ics[r][3]) if short else 0,
               int(ics[r][2]))
        if key not in cfg_map and len(cfg_map) >= NCFG:
            return None
        cfg_idx[r] = cfg_map.setdefault(key, len(cfg_map))
    # cb/sf rows are SFB_SLOTS (=128) wide; band indices span [0, 120)
    coded = np.zeros((R, 128), np.uint8)
    coded[:, :120] = (cb[:, :120] >= 1) & (cb[:, :120] <= 11)
    sf128 = np.zeros((R, 128), np.int16)
    sf128[:, :120] = np.clip(sf[:, :120], -32768, 32767)
    # M/S band mask per pair (excluding intensity/noise bands), vectorized
    ms = batch["msmask"][:F]
    ms_flag = np.zeros((F, 128), np.uint8)
    flag = ms[:, 0]
    ms_flag[flag == 2, :120] = 1
    per_band = flag == 1
    if per_band.any():
        ms_flag[per_band, :120] = ms[per_band, 1:121] != 0
    cbr = cb[1::C, :120]                  # right-channel codebooks (F, 120)
    bad = ((cbr == T.NOISE_CB) | (cbr == T.INTENSITY_CB)
           | (cbr == T.INTENSITY_CB2))
    ms_flag[:, :120][bad] = 0
    # exception rows: TNS / intensity / PNS / int16 overflow
    special = (batch["tnsn"][:R].any(axis=1)
               | (cb >= T.NOISE_CB).any(axis=1))
    frames_special = np.unique(np.where(special)[0] // C)
    if len(frames_special) * C > MAX_SIDE:
        return None
    side_spec = np.zeros((MAX_SIDE, 1024), np.float32)
    side_row = np.full(MAX_SIDE, -1, np.int32)
    dummy_shape = np.zeros(C, np.int32)
    for si, f in enumerate(frames_special):
        sub = {k: (v[f * C:(f + 1) * C] if k not in ("msmask", "rate_index")
                   else (v[f:f + 1] if k == "msmask" else v))
               for k, v in batch.items()}
        sp, _ = SYN.prepare_group(sub, 1, C, dummy_shape.copy())
        for c in range(C):
            side_spec[si * C + c] = sp[0, c]
            side_row[si * C + c] = f * C + c
    # opidx + shape tracking (prev window shape chains frame to frame)
    seqs = ics[:R, 0].astype(np.int32).reshape(F, C)
    shapes = ics[:R, 1].astype(np.int32).reshape(F, C)
    prevs = np.vstack([prev_shape[None, :C], shapes[:-1]])
    opidx = seqs * 4 + prevs * 2 + shapes
    prev_shape[:C] = shapes[-1]
    qt = quant.reshape(F, C, 1024)
    return dict(quant=qt, sf=sf128.reshape(F, C, 128),
                coded=coded.reshape(F, C, 128),
                cfg_idx=cfg_idx.reshape(F, C),
                ms_flag=ms_flag.reshape(F, C // 2, 128),
                side_spec=side_spec, side_row=side_row, opidx=opidx,
                cfg_map=cfg_map)


def cfg_tables(cfg_map: dict,
               ncfg: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    rows = max(ncfg or NCFG, len(cfg_map))
    perm_tab = np.zeros((rows, 1024), np.int32)
    band_tab = np.full((rows, 1024), 127, np.int32)
    for key, i in cfg_map.items():
        if key[3] == 0:
            continue
        src, dst, band = SYN._layout(*key)
        perm_tab[i][dst] = src
        band_tab[i][dst] = band
    return perm_tab, band_tab


def run_device_group(prep: dict, overlap: np.ndarray,
                     bit_depth: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch one assembled group; returns (pcm (C, n) int32, overlap)."""
    perm_tab, band_tab = cfg_tables(prep["cfg_map"])
    qt = prep["quant"]
    if np.abs(qt).max() < 32768:
        qt = qt.astype(np.int16)
    W, SW = SYN.window_bank()
    pcm, new_ov = SYN.dequant_filterbank(
        jnp.asarray(qt), jnp.asarray(prep["sf"]), jnp.asarray(prep["coded"]),
        jnp.asarray(prep["cfg_idx"]), jnp.asarray(perm_tab),
        jnp.asarray(band_tab), jnp.asarray(prep["ms_flag"]),
        jnp.asarray(prep["side_spec"]), jnp.asarray(prep["side_row"]),
        jnp.asarray(prep["opidx"]), jnp.asarray(overlap),
        jnp.asarray(SYN._imdct_matrix(2048)),
        jnp.asarray(SYN._imdct_matrix(256)),
        jnp.asarray(W), jnp.asarray(SW))
    C = prep["quant"].shape[1]
    out = np.asarray(pcm).transpose(1, 0, 2).reshape(C, -1)
    lo, hi = -(1 << (bit_depth - 1)), (1 << (bit_depth - 1)) - 1
    return (np.clip(np.rint(out), lo, hi).astype(np.int32),
            np.asarray(new_ov))


def decode_group_device(batch: dict, nframes: int, channels: int,
                        state: _StreamState,
                        bit_depth: int = 16) -> Optional[np.ndarray]:
    """Device-dequant decode path (single stream); None -> caller falls
    back to decode_group_arrays."""
    prep = prepare_device_group(batch, nframes, channels, state.prev_shape)
    if prep is None:
        return None
    out, state.overlap = run_device_group(prep, state.overlap, bit_depth)
    return out


def frames_from_arrays(batch: dict, nframes: int,
                       channels: int) -> list[BS.FrameData]:
    """Rehydrate FrameData from the native unpacker's dense arrays."""
    frames = []
    ri = batch["rate_index"]
    for f in range(nframes):
        chs = []
        for c in range(channels):
            r = f * channels + c
            ics_row = batch["ics"][r]
            ch = BS.ChannelData()
            ch.ics = BS.IcsInfo(int(ics_row[0]), int(ics_row[1]),
                                int(ics_row[2]), int(ics_row[3]))
            ngroups = len(ch.ics.window_groups())
            msfb = max(ch.ics.max_sfb, 1)
            cb = np.zeros((ngroups, msfb), np.int8)
            sf = np.zeros((ngroups, msfb), np.int32)
            for g in range(ngroups):
                cb[g, :ch.ics.max_sfb] = \
                    batch["cb"][r][g * 15:g * 15 + ch.ics.max_sfb]
                sf[g, :ch.ics.max_sfb] = \
                    batch["sf"][r][g * 15:g * 15 + ch.ics.max_sfb]
            ch.band_cb = cb
            ch.scalefactors = sf
            ch.quant = batch["quant"][r]
            if batch["tnsn"][r].any():
                tns = BS.TnsData()
                for w in range(ch.ics.num_windows):
                    filters = []
                    for fi in range(int(batch["tnsn"][r][w])):
                        length, order, direction = (
                            int(x) for x in batch["tnsp"][r][w * 3 + fi])
                        coeffs = batch["tnsc"][r][w * 3 + fi][:order]
                        filters.append((length, order, direction, coeffs))
                    tns.filters.append(filters)
                ch.tns = tns
            chs.append(ch)
        ms = batch["msmask"][f]
        mask = None
        if channels == 2 and ms[0] != 0xFF and ms[0] != 0:
            ics0 = chs[0].ics
            ngroups = len(ics0.window_groups())
            msfb = max(ics0.max_sfb, 1)
            if ms[0] == 2:
                mask = np.ones((ngroups, msfb), bool)
            else:
                mask = np.zeros((ngroups, msfb), bool)
                for g in range(ngroups):
                    mask[g, :ics0.max_sfb] = \
                        ms[1 + g * 15:1 + g * 15 + ics0.max_sfb] != 0
        frames.append(BS.FrameData(chs, mask, ri))
    return frames


class CodecAacAdts(CodecBase):
    """ADTS-framed AAC-LC (reference CodecAacFdkAdts)."""

    name = "AAC"
    recognition_cost = 30
    mime_types = ("audio/aac", "audio/aacp", "audio/mp4")

    def __init__(self, use_native: Optional[bool] = None):
        self._info: Optional[PcmStreamInfo] = None
        self._buf = b""
        self._state: Optional[_StreamState] = None
        self._hdr: Optional[BS.AdtsHeader] = None
        self._sample_pos = 0
        self._sbr_pending: Optional[tuple] = None
        if use_native is None:
            from ... import native
            use_native = native.have_aac_unpack()
        self._use_native = use_native

    def recognise(self, header: bytes) -> bool:
        # two consecutive valid ADTS headers (the reference requires the
        # same double-sync to avoid false positives)
        h1 = BS.parse_adts_header(header)
        if h1 is None:
            return False
        h2 = BS.parse_adts_header(header, h1.frame_bytes)
        return h2 is not None and h2.rate_index == h1.rate_index

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._buf = reader.read(64 * 1024)
        self._reader = reader
        hdr = BS.parse_adts_header(self._buf)
        if hdr is None:
            raise CodecStreamCorrupt("no ADTS sync")
        self._hdr = hdr
        self._state = _StreamState(hdr.channels)
        self._sample_pos = 0
        # HE-AAC: a low core rate with SBR extension payloads doubles the
        # output rate (reference: AacFdkBase.cpp decodes HE via libSBRdec)
        self._sbr = None
        self._ps = False
        if hdr.sample_rate <= 24000:
            try:
                h2 = BS.parse_adts_header(self._buf)
                br = BitReader(self._buf, h2.header_bytes * 8)
                fr = BS.parse_raw_data_block(br, h2.rate_index)
                if fr.sbr is not None:
                    from .sbr import SbrDecoder
                    self._sbr = SbrDecoder(hdr.sample_rate)
                    if hdr.channels == 1:
                        # Probe with a throwaway decoder: parse_payload
                        # advances delta-coding state (_parse_prev/_ps_prev)
                        # and process() re-parses this same first frame.
                        probe = SbrDecoder(hdr.sample_rate)
                        chans, _c = probe.parse_payload(
                            fr.sbr[0], fr.sbr[1], stereo=False,
                            crc=fr.sbr[2])
                        # PS rides the SBR extension: implicit v2
                        self._ps = chans[0].ps is not None
            except Exception:
                self._sbr = None
                self._ps = False
        rate = hdr.sample_rate * (2 if self._sbr else 1)
        spf = 1024 * (2 if self._sbr else 1)
        total = reader.stream_bytes
        length_j = 0
        if total:
            # estimate duration from first-frame size (CBR-ish)
            frames = total // max(hdr.frame_bytes, 1)
            length_j = frames * spf * Jiffies.per_sample(rate)
        name = "AAC"
        if self._sbr:
            name = "HE-AAC v2" if self._ps else "HE-AAC"
        self._info = PcmStreamInfo(
            sample_rate=rate, bit_depth=16,
            num_channels=2 if self._ps else hdr.channels,
            codec_name=name, lossless=False,
            seekable=False,
            bitrate=hdr.frame_bytes * 8 * hdr.sample_rate // 1024,
            track_length_jiffies=length_j)
        return self._info

    def _fill(self, want: int) -> None:
        while len(self._buf) < want:
            chunk = self._reader.read(128 * 1024)
            if not chunk:
                return
            self._buf += chunk

    def process(self, reader: StreamReader) -> DecodedBatch:
        group = SBR_GROUP_FRAMES if self._sbr is not None else GROUP_FRAMES
        self._fill(self._hdr.frame_bytes * (group + 2))
        if self._sbr is not None:
            return self._process_sbr()
        if self._use_native:
            from ... import native
            n, pos, batch = native.aac_parse_group(
                self._buf, 0, channels=self._hdr.channels,
                max_frames=GROUP_FRAMES)
            self._buf = self._buf[pos:]
            if n == 0:
                raise EndOfStream
            first = self._sample_pos
            self._sample_pos += n * 1024
            state = self._state
            ch = self._hdr.channels
            return DecodedBatch(
                self._info,
                defer=lambda: decode_group_arrays(batch, n, ch, state),
                track_offset_samples=first)
        frames: list[BS.FrameData] = []
        pos = 0
        while len(frames) < GROUP_FRAMES:
            hdr = BS.parse_adts_header(self._buf, pos)
            if hdr is None:
                # resync scan
                nxt = self._buf.find(b"\xff", pos + 1)
                if nxt == -1 or nxt + 7 > len(self._buf):
                    break
                pos = nxt
                continue
            if pos + hdr.frame_bytes > len(self._buf):
                break
            br = BitReader(self._buf, (pos + hdr.header_bytes) * 8)
            try:
                frame = BS.parse_raw_data_block(br, hdr.rate_index)
                if len(frame.channels) == self._hdr.channels:
                    frames.append(frame)
            except (BS.AacError, ValueError, EOFError):
                pass
            pos += hdr.frame_bytes
        self._buf = self._buf[pos:]
        if not frames:
            raise EndOfStream
        first = self._sample_pos
        self._sample_pos += len(frames) * 1024
        state = self._state
        return DecodedBatch(
            self._info,
            defer=lambda: decode_frames(frames, state),
            track_offset_samples=first)

    def _parse_python_frames(self,
                             max_frames: int = SBR_GROUP_FRAMES) -> list:
        frames: list[BS.FrameData] = []
        pos = 0
        while len(frames) < max_frames:
            hdr = BS.parse_adts_header(self._buf, pos)
            if hdr is None:
                nxt = self._buf.find(b"\xff", pos + 1)
                if nxt == -1 or nxt + 7 > len(self._buf):
                    break
                pos = nxt
                continue
            if pos + hdr.frame_bytes > len(self._buf):
                break
            br = BitReader(self._buf, (pos + hdr.header_bytes) * 8)
            try:
                frame = BS.parse_raw_data_block(br, hdr.rate_index)
                if len(frame.channels) == self._hdr.channels:
                    frames.append(frame)
            except (BS.AacError, ValueError, EOFError):
                pass
            pos += hdr.frame_bytes
        self._buf = self._buf[pos:]
        return frames

    def _parse_native_sbr_group(self) -> Optional[tuple]:
        """HE-AAC group parse through the C++ unpacker (same hot loop as
        the LC bench path, plus SBR fill-payload capture).  Returns
        (nframes, batch) with the dense arrays kept as-is — the decode
        path preps spectra vectorized from them and only rehydrates
        FrameData objects if it must fall back to the per-frame numpy
        chain.  None -> caller uses the Python parser."""
        from ... import native
        try:
            n, pos, batch = native.aac_parse_group_sbr(
                self._buf, 0, channels=self._hdr.channels,
                max_frames=SBR_GROUP_FRAMES)
        except (RuntimeError, OSError):
            return None
        self._buf = self._buf[pos:]
        return n, batch

    def _parse_dispatch_sbr_group(self) -> Optional[tuple]:
        """Parse one SBR group and dispatch its decode (device calls
        async).  Returns (resolve, track_offset, nsamples) or None at
        end of stream."""
        self._fill(self._hdr.frame_bytes * (SBR_GROUP_FRAMES + 2))
        frames = batch = None
        n = 0
        if self._use_native:
            parsed = self._parse_native_sbr_group()
            if parsed is not None:
                n, batch = parsed
        if batch is None:
            frames = self._parse_python_frames()
            n = len(frames)
        if not n:
            return None
        resolve, ns = _sbr_decode_frames_lazy(
            frames, self._state, self._sbr, self._hdr.channels,
            ps=self._ps, batch=batch, nframes=n)
        first = self._sample_pos
        self._sample_pos += ns
        return resolve, first, ns

    def _process_sbr(self) -> DecodedBatch:
        """One-group software pipeline: group k's device program runs
        while this call parses and dispatches group k+1; the returned
        batch is the OLDEST in-flight group (offsets carried per
        group, so timing is exact — one group of added latency)."""
        if self._sbr_pending is None:
            self._sbr_pending = self._parse_dispatch_sbr_group()
            if self._sbr_pending is None:
                raise EndOfStream
        nxt = self._parse_dispatch_sbr_group()
        resolve, first, _ns = self._sbr_pending
        self._sbr_pending = nxt
        return DecodedBatch(self._info, samples=resolve(),
                            track_offset_samples=first)


def _sbr_decode_frames(frames, state, sbr, nch,
                       ps: bool = False, batch: Optional[dict] = None,
                       nframes: int = 0) -> np.ndarray:
    """Core decode + SBR reconstruction for a group of parsed frames
    (shared by the ADTS and MP4 codecs; AacFdkBase.cpp feeds both
    transports through the same libSBRdec instance).  With ``ps`` the
    mono core becomes stereo through the parametric-stereo tool.

    Without PS the group runs through the batched device path
    (codecs/aac/sbr_jax.py: QMF, HF generator and envelope adjustment
    under one jit over the whole group); PS and irregular groups
    (missing payloads, header changes mid-group) use the per-frame
    numpy chain."""
    resolve, _ns = _sbr_decode_frames_lazy(frames, state, sbr, nch,
                                           ps=ps, batch=batch,
                                           nframes=nframes)
    return resolve()


def _sbr_decode_frames_lazy(frames, state, sbr, nch,
                            ps: bool = False,
                            batch: Optional[dict] = None,
                            nframes: int = 0) -> tuple:
    """_sbr_decode_frames with async device dispatch: returns
    (resolve, nsamples_out).  ``resolve()`` blocks on the device
    download — the caller can parse/dispatch the next group first so
    the chip works while the host parses (jax async dispatch).  The
    numpy fallback materializes eagerly (resolve is then free)."""
    from .sbr import SbrError
    if not ps:
        out = _sbr_decode_frames_device(frames, state, sbr, nch,
                                        batch=batch, nframes=nframes,
                                        lazy=True)
    else:
        out = _sbr_decode_frames_device_ps(frames, state, sbr,
                                           batch=batch, nframes=nframes,
                                           lazy=True)
    if out is not None:
        F = nframes if batch is not None else len(frames)
        return out, F * 2048
    # the device path fused the LC core: its overlap tail must come
    # back to the host before the per-frame numpy chain continues
    _sync_core_overlap(sbr, state)
    if frames is None:
        # device path declined a native-parsed group: rehydrate objects
        # for the per-frame numpy chain
        frames = frames_from_arrays(batch, nframes, nch)
        for f, fr in enumerate(frames):
            fr.sbr = batch["sbr"][f]
    outs = []
    for fr in frames:
        core = decode_frames_float([fr], state)
        if fr.sbr is not None:
            payload, nbits, crc = fr.sbr
            try:
                chans, coupling = sbr.parse_payload(
                    payload, nbits, stereo=(nch == 2), crc=crc)
                if ps:
                    outs.append(sbr.process_frame_ps(core, chans))
                else:
                    outs.append(sbr.process_frame(core, chans,
                                                  coupling))
                continue
            except SbrError:
                pass
        # no/invalid payload: plain 2x hold upsample keeps timing
        up = np.repeat(core, 2, axis=1)
        outs.append(np.repeat(up, 2, axis=0) if ps else up)
    pcm = np.concatenate(outs, axis=1)
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    return (lambda: pcm), pcm.shape[1]


def _sync_core_overlap(sbr, state: _StreamState) -> None:
    """Pull the fused core-overlap tail back from any device runner
    into the host _StreamState — called before a numpy-fallback group
    (or a runner rebuild) so the LC filterbank chain stays continuous
    across path switches."""
    for attr in ("_device_runner", "_ps_device_runner"):
        r = getattr(sbr, attr, None)
        if r is not None:
            ov = r.fetch_core_overlap()
            if ov is not None:
                nch = len(state.prev_shape)
                state.overlap = np.asarray(ov, np.float64) \
                    .reshape(-1, 1024)[:nch]


def _sbr_decode_frames_device_ps(frames, state, sbr,
                                 batch: Optional[dict] = None,
                                 nframes: int = 0, lazy: bool = False):
    """Batched device HE-AAC v2: mono core + device SBR + device
    parametric stereo (sbr_jax.SbrPsDeviceRunner).  Returns None to
    fall back to the numpy per-frame chain; with ``lazy`` returns a
    zero-arg resolve function instead of the array."""
    from . import sbr_jax
    from .sbr import SbrError
    header0 = sbr.header
    # shallow list copy: parse advances by REPLACING _parse_prev items
    # (tuples of fresh rows), never mutating them - so restoring the
    # list restores the state (deepcopy cost ~90 ms/stream)
    pp = getattr(sbr, "_parse_prev", None)
    snap = (list(pp) if pp is not None else None,
            getattr(sbr, "_ps_prev", None))
    payloads = (batch["sbr"][:nframes] if batch is not None
                else [fr.sbr for fr in frames])
    parsed = []
    try:
        for pl in payloads:
            if pl is None:
                raise SbrError("missing payload in group")
            payload, nbits, crc = pl
            chans, _c = sbr.parse_payload(payload, nbits, stereo=False,
                                          crc=crc)
            if header0 is not None and sbr.header != header0:
                raise SbrError("header change mid-group")
            header0 = sbr.header
            E, Q, _a = sbr.dequant(sbr.header, chans[0].grid,
                                   chans[0].env, chans[0].noise)
            parsed.append((chans[0], E, Q, chans[0].ps))
    except SbrError:
        if snap[0] is not None:
            sbr._parse_prev = snap[0]
        sbr._ps_prev = snap[1]
        return None
    runner = getattr(sbr, "_ps_device_runner", None)
    if runner is None or runner.dec is not sbr \
            or runner.static_header != header0:
        _sync_core_overlap(sbr, state)  # old runner may hold the tail
        runner = sbr_jax.SbrPsDeviceRunner(sbr)
        runner.static_header = header0
        sbr._ps_device_runner = runner
    if runner.pdec_host.last_ps is None \
            and parsed and parsed[0][3] is None:
        return None              # no PS params yet: numpy handles it
    F = nframes if batch is not None else len(frames)
    # host prep stops at spectra: the mono LC IMDCT + overlap-add runs
    # inside the SBR device program (same wire bytes as PCM)
    if batch is not None:
        specs, ops = SYN.prepare_group(batch, F, 1, state.prev_shape)
    else:
        specs, ops = group_specs_from_frames(frames, state)
    resolve = runner.decode_group_lazy_spec(specs[:, 0], ops[:, 0],
                                            [p[0] for p in parsed],
                                            [p[1] for p in parsed],
                                            [p[2] for p in parsed],
                                            [p[3] for p in parsed],
                                            state.overlap[0])
    if lazy:
        return lambda: resolve().astype(np.int32)
    return resolve().astype(np.int32)  # rounded to int16 on device


def _sbr_decode_frames_device(frames, state, sbr, nch,
                              batch: Optional[dict] = None,
                              nframes: int = 0, lazy: bool = False):
    """Batched device SBR for a regular group (every frame carries a
    payload, one header).  Returns None to fall back to the numpy
    per-frame path; with ``lazy`` the device call is dispatched and a
    zero-arg resolve function is returned instead of the array."""
    from . import sbr_jax
    from .sbr import SbrError
    header0 = sbr.header
    # snapshot the delta-coding parse state: a fallback re-parses the
    # same payloads through the numpy path.  Shallow list copy suffices:
    # parse REPLACES _parse_prev items (tuples of fresh rows), never
    # mutates them.
    pp = getattr(sbr, "_parse_prev", None)
    snap = (list(pp) if pp is not None else None,
            getattr(sbr, "_ps_prev", None))
    payloads = (batch["sbr"][:nframes] if batch is not None
                else [fr.sbr for fr in frames])
    parsed = []
    try:
        for pl in payloads:
            if pl is None:
                raise SbrError("missing payload in group")
            payload, nbits, crc = pl
            chans, coupling = sbr.parse_payload(
                payload, nbits, stereo=(nch == 2), crc=crc)
            if header0 is not None and sbr.header != header0:
                raise SbrError("header change mid-group")
            header0 = sbr.header
            if chans[0].ps is not None and nch == 1:
                raise SbrError("PS stream")
            EQ = [sbr.dequant(sbr.header, chans[i].grid,
                              chans[i].env, chans[i].noise)
                  for i in range(nch)]
            if nch == 2 and coupling:
                a = EQ[0][2]
                (EL, QL), (ER, QR) = sbr.unmap_coupled(
                    EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a)
                EQ = [(EL, QL, a), (ER, QR, a)]
            parsed.append((chans, EQ))
    except SbrError:
        if snap[0] is not None:
            sbr._parse_prev = snap[0]
        sbr._ps_prev = snap[1]
        return None
    runner = getattr(sbr, "_device_runner", None)
    if runner is None or runner.dec is not sbr \
            or runner.static_header != header0:
        _sync_core_overlap(sbr, state)  # old runner may hold the tail
        runner = sbr_jax.SbrDeviceRunner(sbr)
        runner.static_header = header0
        sbr._device_runner = runner
    F = nframes if batch is not None else len(frames)
    # host prep stops at spectra: the LC IMDCT + overlap-add runs
    # inside the SBR device program (same wire bytes as PCM)
    if batch is not None:
        specs, ops = SYN.prepare_group(batch, F, nch, state.prev_shape)
    else:
        specs, ops = group_specs_from_frames(frames, state)
    per_ch = [([p[0][ch] for p in parsed],
               [p[1][ch][0] for p in parsed],
               [p[1][ch][1] for p in parsed]) for ch in range(nch)]
    resolve = runner.decode_group_multi_lazy_spec(
        np.ascontiguousarray(specs.transpose(1, 0, 2)),
        np.ascontiguousarray(ops.T), per_ch, state.overlap)
    return resolve if lazy else resolve()


def parse_audio_specific_config(asc: bytes) -> tuple:
    """AudioSpecificConfig -> (rate_index, channels, sbr_explicit,
    ps_explicit).  Accepts AOT 2 (LC) and the AOT 5/29 explicit-SBR
    hierarchy whose core is LC (tpdec_asc.cpp AudioSpecificConfig_Parse:
    aot, samplingFrequencyIndex, channelConfiguration, then for 5/29 the
    extension rate and the core AOT).  AOT 29 explicitly signals the
    parametric-stereo tool: the caller must force 2-channel output even
    if the first frame carries no ps_data yet (fdk tpdec_asc forces
    stereo for AOT 29 regardless of payload)."""
    br = BitReader(asc)
    aot = br.read(5)
    rate_idx = br.read(4)
    if rate_idx == 0xF:
        br.read(24)
        raise CodecStreamCorrupt("explicit AAC sample rate unsupported")
    channels = br.read(4)
    sbr_explicit = False
    ps_explicit = aot == 29
    if aot in (5, 29):
        ext_idx = br.read(4)
        if ext_idx == 0xF:
            br.read(24)
        aot = br.read(5)
        sbr_explicit = True
    if aot != 2:
        raise CodecStreamCorrupt(f"not AAC-LC (AOT {aot})")
    return rate_idx, channels, sbr_explicit, ps_explicit


class CodecAacMp4(CodecBase):
    """AAC-LC / HE-AAC in MP4 (reference CodecAacFdkMp4): drives the
    ISO-BMFF sample tables from containers.mpeg4.  SBR is detected
    both explicitly (AOT 5/29 AudioSpecificConfig) and implicitly
    (low-rate LC with SBR FIL payloads in the first sample)."""

    name = "AAC-MP4"
    recognition_cost = 25
    mime_types = ("audio/mp4", "audio/m4a")

    def __init__(self):
        self._info = None
        self._track = None
        self._samples = None
        self._index = 0
        self._state = None
        self._data = b""

    def recognise(self, header: bytes) -> bool:
        if len(header) < 12 or header[4:8] != b"ftyp":
            return False
        from ...containers.mpeg4 import find_audio_track
        try:
            track = find_audio_track(header)
        except Exception:                                 # noqa: BLE001
            return False
        return track is not None and track.codec == "mp4a"

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        from ...containers.mpeg4 import find_audio_track
        self._data = reader.read(reader.stream_bytes or (1 << 30))
        track = find_audio_track(self._data)
        if track is None or track.codec != "mp4a":
            raise CodecStreamCorrupt("no mp4a track")
        asc = track.codec_config
        if len(asc) < 2:
            raise CodecStreamCorrupt("missing AudioSpecificConfig")
        rate_idx, channels, sbr_explicit, ps_explicit = \
            parse_audio_specific_config(asc)
        self._track = track
        self._rate_index = rate_idx
        self._samples = list(track.sample_offsets())
        self._index = 0
        self._sample_pos = 0
        self._state = _StreamState(channels)
        rate = T.SAMPLE_RATES[rate_idx]
        self._sbr = None
        self._ps = False
        if sbr_explicit or rate <= 24000:
            try:
                off, size = self._samples[0]
                br = BitReader(self._data[off:off + size])
                fr = BS.parse_raw_data_block(br, rate_idx)
                if fr.sbr is not None:
                    from .sbr import SbrDecoder
                    self._sbr = SbrDecoder(rate)
                    if channels == 1:
                        # Throwaway probe decoder: parse_payload mutates
                        # delta-coding state and process() re-parses this
                        # same first sample.
                        probe = SbrDecoder(rate)
                        chs, _c = probe.parse_payload(
                            fr.sbr[0], fr.sbr[1], stereo=False,
                            crc=fr.sbr[2])
                        self._ps = chs[0].ps is not None
            except Exception:                             # noqa: BLE001
                self._sbr = None
                self._ps = False
        if ps_explicit and channels == 1:
            # AOT 29 explicitly signals PS: force HE-AAC v2 stereo even
            # when the first sample carries no ps_data (header may arrive
            # later) or the probe failed — fdk tpdec_asc does the same.
            if self._sbr is None:
                from .sbr import SbrDecoder
                self._sbr = SbrDecoder(rate)
            self._ps = True
        spf = 1024 * (2 if self._sbr else 1)
        out_rate = rate * (2 if self._sbr else 1)
        name = "AAC"
        if self._sbr:
            name = "HE-AAC v2" if self._ps else "HE-AAC"
        self._info = PcmStreamInfo(
            sample_rate=out_rate, bit_depth=16,
            num_channels=2 if self._ps else channels,
            codec_name=name,
            lossless=False, seekable=self._sbr is None,
            track_length_jiffies=track.total_samples * spf
            * Jiffies.per_sample(out_rate) if track.stts else 0)
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        if self._index >= len(self._samples):
            raise EndOfStream
        frames = []
        group = SBR_GROUP_FRAMES if self._sbr is not None else GROUP_FRAMES
        while self._index < len(self._samples) and len(frames) < group:
            off, size = self._samples[self._index]
            self._index += 1
            raw = self._data[off:off + size]
            br = BitReader(raw)
            try:
                frames.append(BS.parse_raw_data_block(br, self._rate_index))
            except (BS.AacError, ValueError, EOFError):
                continue
        if not frames:
            raise EndOfStream
        first = self._sample_pos
        if self._sbr is not None:
            pcm = _sbr_decode_frames(
                frames, self._state, self._sbr,
                1 if self._ps else self._info.num_channels,
                ps=self._ps)
            self._sample_pos += pcm.shape[1]
            return DecodedBatch(self._info, samples=pcm,
                                track_offset_samples=first)
        self._sample_pos += len(frames) * 1024
        state = self._state
        return DecodedBatch(
            self._info, defer=lambda: decode_frames(frames, state),
            track_offset_samples=first)

    def try_seek(self, sample: int) -> Optional[int]:
        idx, pcm0 = self._track.seek_sample(sample)
        self._index = idx
        self._sample_pos = pcm0
        self._state = _StreamState(self._info.num_channels)
        return 0   # data already buffered; no upstream reposition needed


def decode_adts(data: bytes) -> tuple[PcmStreamInfo, np.ndarray]:
    """Whole-buffer ADTS decode (tests/tools)."""
    from ..base import BufferReader
    codec = CodecAacAdts()
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    return info, (np.concatenate(parts, axis=1) if parts
                  else np.zeros((info.num_channels, 0), np.int32))
