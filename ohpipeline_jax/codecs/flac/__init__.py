"""FLAC codec: host entropy decode + batched device synthesis.

Parity target: OpenHome/Media/Codec/Flac.cpp (adapter over libFLAC) and
flac-1.2.1's stream_decoder.c — bit-exact decoded PCM, seek via the seek
table / binary search, ogg-FLAC handled by the Ogg container layer.

Host/device split (SURVEY.md §7.3): Rice/header unpack on host (Python
reference implementation here; C++ fast path in ohpipeline_jax/native),
then *all* frames of a group are synthesised in one fused device program:
LPC recurrence (ops.lpc) -> wasted-bit shift -> inter-channel
decorrelation.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.jiffies import Jiffies
from ...core.streaminfo import PcmStreamInfo
from ...ops import lpc as lpc_ops
from ...ops import pcm as pcm_ops
from ..base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                    StreamReader)
from . import frames as F
from .bitreader import BitReader
from .encoder import encode_flac

__all__ = ["CodecFlac", "encode_flac", "decode_flac"]

#: frames per device dispatch for a single stream (~16 x 4096 = 1.5s @44k)
GROUP_FRAMES = 16


@functools.partial(jax.jit, static_argnames=("num_channels",))
def _synthesise_group(data, coeffs, shift, order, wasted, assign,
                      num_channels: int):
    """Fused device program for a group of FLAC frames.

    data (B, N) int32, B = nframes * num_channels (rows frame-major);
    coeffs (B, 32), shift/order/wasted (B,), assign (nframes,) raw channel
    assignment codes.  Returns (nframes, num_channels, N) int32 PCM.
    """
    # inputs may arrive narrowed (int16/int8) to halve transfer bytes
    data = data.astype(jnp.int32)
    coeffs = coeffs.astype(jnp.int32)
    shift = shift.astype(jnp.int32)
    order = order.astype(jnp.int32)
    wasted = wasted.astype(jnp.int32)
    assign = assign.astype(jnp.int32)
    synth = lpc_ops.lpc_synthesize(data, coeffs, shift, order)
    synth = jnp.left_shift(synth, wasted[:, None])
    B, N = data.shape
    nframes = B // num_channels
    chans = synth.reshape(nframes, num_channels, N)
    if num_channels != 2:
        return chans
    mode = jnp.where(assign == F.ASSIGN_LEFT_SIDE, pcm_ops.CH_LEFT_SIDE,
                     jnp.where(assign == F.ASSIGN_RIGHT_SIDE,
                               pcm_ops.CH_RIGHT_SIDE,
                               jnp.where(assign == F.ASSIGN_MID_SIDE,
                                         pcm_ops.CH_MID_SIDE,
                                         pcm_ops.CH_INDEPENDENT)))
    left, right = pcm_ops.stereo_decorrelate(chans[:, 0], chans[:, 1], mode)
    return jnp.stack([left, right], axis=1)


def _synthesise_group12(pack12, warm, esc_row, esc_pos, esc_val,
                        coeffs, shift, order, wasted, assign, num_channels):
    """_synthesise_group fed by the 12-bit wire pack
    (native.flac_parse_group12): two residuals per three bytes, raw
    warm-up in `warm` (B, 32) int32, |v| >= 2048 residuals as escape
    triples.  ~25% fewer host->device bytes than int16 rows."""
    B, pbytes = pack12.shape
    stride = pbytes * 2 // 3
    b = pack12.reshape(B, stride // 2, 3).astype(jnp.int32)
    v0 = (b[..., 0] << 4) | (b[..., 1] >> 4)
    v1 = ((b[..., 1] & 15) << 8) | b[..., 2]
    d = jnp.stack([((v0 + 2048) & 4095) - 2048,
                   ((v1 + 2048) & 4095) - 2048], axis=-1).reshape(B, stride)
    flat = d.reshape(-1)
    dummy = B * stride
    eidx = jnp.where(esc_row >= 0, esc_row * stride + esc_pos, dummy)
    flat = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
    flat = flat.at[eidx].set(esc_val)
    d = flat[:dummy].reshape(B, stride)
    pos = jnp.arange(32)
    d = d.at[:, :32].set(jnp.where(pos[None, :] < order[:, None],
                                   warm, d[:, :32]))
    return _synthesise_group(d, coeffs, shift, order, wasted, assign,
                             num_channels)


def _synthesise_group_zz(lo, hi, warm, esc_row, esc_pos, esc_val,
                         coeffs, shift, order, wasted, assign, num_channels):
    """_synthesise_group fed by the zigzag byte-plane wire
    (native.flac_parse_group_zz): a low-byte plane (B, stride) u8 plus a
    packed high-nibble plane (B, stride//2) u8 — the high plane is mostly
    zero; decode is
    pure elementwise (no gathers)."""
    B, stride = lo.shape
    h = hi.astype(jnp.int32)
    hfull = jnp.stack([h & 15, h >> 4], axis=-1).reshape(B, stride)
    zz = lo.astype(jnp.int32) | (hfull << 8)
    d = (zz >> 1) ^ -(zz & 1)
    flat = d.reshape(-1)
    dummy = B * stride
    eidx = jnp.where(esc_row >= 0, esc_row * stride + esc_pos, dummy)
    flat = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
    flat = flat.at[eidx].set(esc_val)
    d = flat[:dummy].reshape(B, stride)
    pos = jnp.arange(32)
    d = d.at[:, :32].set(jnp.where(pos[None, :] < order[:, None],
                                   warm, d[:, :32]))
    return _synthesise_group(d, coeffs, shift, order, wasted, assign,
                             num_channels)


def _synthesise_group_rice(bits, gcur, gk, ocur, okk, omode, ocnt, orow,
                           opos, cfrow, cfval, cfn, warm,
                           esc_row, esc_pos, esc_val,
                           coeffs, shift, order, wasted, assign,
                           num_channels):
    """_synthesise_group fed by the rice wire: the entropy-coded stream
    bytes themselves (native.flac_parse_group_rice) — the device decodes
    the rice codes (rice_jax.decode_units), then patches escapes and
    warm-up samples and synthesises as usual.  ~0.7 bytes/sample on the
    host->device copy instead of the zigzag planes' 1.5."""
    from . import rice_jax
    d = rice_jax.decode_units(bits, gcur, gk, ocur, okk, omode, ocnt,
                              orow, opos, cfrow, cfval, cfn)
    B, stride = d.shape
    flat = d.reshape(-1)
    dummy = B * stride
    eidx = jnp.where(esc_row >= 0, esc_row * stride + esc_pos, dummy)
    flat = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
    flat = flat.at[eidx].set(esc_val)
    d = flat[:dummy].reshape(B, stride)
    pos = jnp.arange(32)
    d = d.at[:, :32].set(jnp.where(pos[None, :] < order[:, None],
                                   warm, d[:, :32]))
    return _synthesise_group(d, coeffs, shift, order, wasted, assign,
                             num_channels)


#: `_synthesise_group_rice` compiled once per channel count and shape,
#: shared by every call of the serving API
synthesise_group_rice_jit = jax.jit(_synthesise_group_rice,
                                    static_argnames=("num_channels",))


def synthesise_batch(batch: dict, num_channels: int,
                     nframes: int) -> np.ndarray:
    """Run the fused device program over a parsed batch dict (layout of
    native.flac_parse_group) and reassemble (channels, samples) PCM.

    Every row of the batch goes to the device, the unused ones zero, so
    the program's shape is the batch's capacity: a short last group or a
    group after a seek reuses the compiled program."""
    if nframes == 0:
        return np.zeros((num_channels, 0), np.int32)
    out = np.asarray(_synthesise_group(
        *(jnp.asarray(batch[k]) for k in ("data", "coeffs", "shift",
                                          "order", "wasted", "assign")),
        num_channels))[:nframes]
    bs = batch["blocksize"]
    if all(bs[i] == out.shape[2] for i in range(nframes)):
        return out.transpose(1, 0, 2).reshape(num_channels, -1)
    return np.concatenate(
        [out[fi, :, :bs[fi]] for fi in range(nframes)], axis=1)


def frames_to_batch(parsed: list["F.Frame"], num_channels: int) -> dict:
    """Pack Python-parsed frames into the dense batch-dict layout, with
    capacity for a whole number of `GROUP_FRAMES` groups."""
    maxn = max(f.header.blocksize for f in parsed)
    nf = -(-len(parsed) // GROUP_FRAMES) * GROUP_FRAMES
    B = nf * num_channels
    batch = dict(
        data=np.zeros((B, maxn), np.int32),
        coeffs=np.zeros((B, lpc_ops.MAX_ORDER), np.int32),
        shift=np.zeros(B, np.int32), order=np.zeros(B, np.int32),
        wasted=np.zeros(B, np.int32),
        assign=np.zeros(nf, np.int32),
        blocksize=np.zeros(nf, np.int32),
        sample_number=np.zeros(nf, np.int64))
    for fi, fr in enumerate(parsed):
        batch["assign"][fi] = fr.header.assignment
        batch["blocksize"][fi] = fr.header.blocksize
        batch["sample_number"][fi] = fr.header.sample_number
        for ci, sub in enumerate(fr.subframes):
            b = fi * num_channels + ci
            batch["data"][b, :len(sub.data)] = sub.data
            batch["coeffs"][b, :len(sub.coeffs)] = sub.coeffs
            batch["shift"][b] = sub.shift
            batch["order"][b] = sub.order
            batch["wasted"][b] = sub.wasted_bits
    return batch


def synthesise_frames(parsed: list["F.Frame"],
                      num_channels: int) -> np.ndarray:
    """Batch a list of parsed frames onto the device; returns (channels,
    total_samples) int32 PCM (frames concatenated in order)."""
    if not parsed:
        return np.zeros((num_channels, 0), np.int32)
    return synthesise_batch(frames_to_batch(parsed, num_channels),
                            num_channels, len(parsed))


class CodecFlac(CodecBase):
    name = "FLAC"
    recognition_cost = 20
    mime_types = ("audio/flac", "audio/x-flac")

    def __init__(self, use_native: Optional[bool] = None):
        self._meta: Optional[F.Metadata] = None
        self._info: Optional[PcmStreamInfo] = None
        self._buf = b""
        self._bit_pos = 0
        self._sample_pos = 0
        if use_native is None:
            from ... import native
            use_native = native.have_flac_unpack()
        self._use_native = use_native

    def recognise(self, header: bytes) -> bool:
        return header[:4] == b"fLaC"

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        # Buffer the whole metadata prefix, then stream frames.
        head = reader.read(64 * 1024)
        try:
            self._meta = F.parse_metadata(head)
        except F.FlacError as e:
            raise CodecStreamCorrupt(str(e)) from e
        si = self._meta.streaminfo
        self._buf = head
        self._bit_pos = self._meta.header_bytes * 8
        self._reader = reader
        self._sample_pos = 0
        self._info = PcmStreamInfo(
            sample_rate=si.sample_rate, bit_depth=si.bits_per_sample,
            num_channels=si.channels, codec_name="FLAC", lossless=True,
            seekable=True,
            bitrate=(si.sample_rate * si.channels * si.bits_per_sample) // 2,
            track_length_jiffies=si.total_samples
            * Jiffies.per_sample(si.sample_rate))
        return self._info

    def _fill(self, want: int) -> None:
        while len(self._buf) * 8 - self._bit_pos < want * 8:
            chunk = self._reader.read(256 * 1024)
            if not chunk:
                return
            # drop consumed whole bytes to bound the buffer
            consumed = self._bit_pos // 8
            if consumed > 128 * 1024:
                self._buf = self._buf[consumed:]
                self._bit_pos -= consumed * 8
            self._buf += chunk

    def process(self, reader: StreamReader) -> DecodedBatch:
        si = self._meta.streaminfo
        max_frame = si.max_framesize or (
            si.max_blocksize * si.channels * 5 + 1024)
        if self._use_native:
            return self._process_native(max_frame)
        parsed: list[F.Frame] = []
        first_sample = self._sample_pos
        while len(parsed) < GROUP_FRAMES:
            self._fill(max_frame * 2)
            br = BitReader(self._buf, self._bit_pos)
            if br.bits_left < 16:
                break
            try:
                fr = F.parse_frame(br, si)
            except (EOFError, ValueError):
                break
            except F.FlacError:
                # lost sync: scan forward (stream_decoder.c resync)
                nxt = F.resync(self._buf, (self._bit_pos // 8) + 1, si)
                if nxt is None:
                    break
                self._bit_pos = nxt * 8
                continue
            self._bit_pos = br.pos
            parsed.append(fr)
            self._sample_pos = fr.header.sample_number + fr.header.blocksize
        if not parsed:
            raise EndOfStream
        nch = si.channels
        return DecodedBatch(
            self._info,
            defer=lambda: synthesise_frames(parsed, nch),
            track_offset_samples=first_sample)

    def _process_native(self, max_frame: int) -> DecodedBatch:
        from ... import native
        si = self._meta.streaminfo
        self._fill(max_frame * (GROUP_FRAMES + 1))
        nframes, pos, _status, batch = native.flac_parse_group(
            self._buf, self._bit_pos, sample_rate=si.sample_rate,
            bits_per_sample=si.bits_per_sample,
            max_blocksize=si.max_blocksize, channels=si.channels,
            max_frames=GROUP_FRAMES)
        if nframes == 0:
            raise EndOfStream
        self._bit_pos = pos
        first_sample = int(batch["sample_number"][0])
        self._sample_pos = (int(batch["sample_number"][nframes - 1])
                            + int(batch["blocksize"][nframes - 1]))
        nch = si.channels
        return DecodedBatch(
            self._info,
            defer=lambda: synthesise_batch(batch, nch, nframes),
            track_offset_samples=first_sample)

    def try_seek(self, sample: int) -> Optional[int]:
        """Sample -> byte via seek table, else proportional guess + resync
        (the reference's libFLAC does binary search; proportional + resync
        reaches the same frame for CBR-ish streams)."""
        if self._meta is None:
            return None
        si = self._meta.streaminfo
        base = self._meta.header_bytes
        best = None
        for s, off, _n in self._meta.seek_points:
            if s <= sample:
                best = (s, off)
        if best is not None:
            self._sample_pos = best[0]
            return base + best[1]
        if si.total_samples and self._reader.stream_bytes:
            frac = sample / si.total_samples
            pos = base + int(frac * (self._reader.stream_bytes - base))
            self._sample_pos = sample  # refined by next frame header
            return pos
        return None

    def notify_seek_done(self, byte_pos: int) -> None:
        """Reset internal buffering after the upstream repositioned."""
        self._buf = b""
        self._bit_pos = 0


def decode_flac(data: bytes, use_native: Optional[bool] = None
                ) -> tuple[PcmStreamInfo, np.ndarray]:
    """Whole-buffer decode (tests, tools): bit-exact PCM."""
    from ..base import BufferReader
    codec = CodecFlac(use_native=use_native)
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    pcm = (np.concatenate(parts, axis=1) if parts
           else np.zeros((info.num_channels, 0), np.int32))
    return info, pcm
