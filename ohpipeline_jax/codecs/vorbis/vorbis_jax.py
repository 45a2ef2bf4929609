"""Batched device Vorbis synthesis.

Host entropy stays where it is (floors/residues via native
vorbis_core.cc); everything downstream of the entropy-decoded
per-channel spectra — the IMDCT, the lapped Vorbis window and the
variable-hop overlap-add — runs as dense matmuls plus ONE
scatter-add per group of blocks, batched across streams (the
multi-stream serving shape, the same stance as celt_jax/sbr_jax; the
host path in synthesis.py stays the single-stream default and the
conformance oracle).

Why this shape is device-friendly despite Vorbis' variable block
sizes: for a fixed window config (blocksize, prev_full, next_full)
the map spectrum -> windowed time block is LINEAR, and a stream only
ever uses five configs (short, long x {TT, TF, FT, FF}).  Each block
is therefore one row of a (G, n1/2) x (n1/2, n1) matmul against its
config's operator (short-block operators are zero-padded into the
long layout), selected per block with a one-hot weight — five dense
matmuls per group, no data-dependent control flow.  Block placement
(the n_prev/4 + n_cur/4 center walk) is host integer math shipped as
an int32 offset vector; the overlap-add is one flat scatter-add into
the group timeline.  Group-to-group lapping is carried as a fixed
(ch, n1/2) float tail, so every group of every stream hits the same
compiled program.

Wire: spectra ship as int16 with a per-block/channel float scale
(celt_jax's X-wire discipline; error is relative to the block's peak
coefficient, measured >= 60 dB vs the float64 host path and <= 2 LSB
on the int16 PCM in tests/test_vorbis_device.py).

Reference displaced: Tremor mdct.c + window.c + the synthesis lapping
in block.c, behind OpenHome/Media/Codec/Vorbis.cpp; this module is
the serving-shape equivalent, not a translation (the reference does
one recursive FFT-style IMDCT per block on the CPU).
"""

from __future__ import annotations

import functools

import numpy as np

from ..base import BufferReader
from ...containers.ogg import OggReader
from .codebook import VorbisError
from .headers import (VorbisInfo, parse_comment, parse_identification,
                      parse_setup)
from .synthesis import PacketDecoder, _imdct_op, window_vector

#: config ids: 0 = short block; long blocks 1..4 by (prev_full, next_full)
N_CONFIGS = 5

_GROUP_JIT: dict = {}


def _config_id(n: int, bs1: int, prev_full: bool, next_full: bool) -> int:
    if n != bs1:
        return 0
    return 1 + (0 if prev_full else 2) + (0 if next_full else 1)


@functools.lru_cache(maxsize=None)
def _operators(bs0: int, bs1: int) -> np.ndarray:
    """(5, bs1/2, bs1) stacked IMDCT+window linear maps, short padded
    into the long layout (zero rows/cols beyond bs0/2 x bs0)."""
    if bs1 > 4096:
        raise VorbisError(f"device path supports bs1 <= 4096, got {bs1}")
    half1 = bs1 // 2
    ops = np.zeros((N_CONFIGS, half1, bs1), np.float32)
    w0 = window_vector(bs0, True, True, bs0)
    ops[0, :bs0 // 2, :bs0] = _imdct_op(bs0) * w0[None, :].astype(np.float32)
    for cid, (pf, nf) in ((1, (True, True)), (2, (True, False)),
                          (3, (False, True)), (4, (False, False))):
        w = window_vector(bs1, pf, nf, bs0)
        ops[cid] = _imdct_op(bs1) * w[None, :].astype(np.float32)
    return ops


def capture_stream_iter(data: bytes):
    """Host entropy decode of an Ogg Vorbis stream, streamed ->
    (VorbisInfo, iterator of (n, prev_full, next_full, spectra (ch,
    n/2) f64)).  Lazy so multi-stream decode holds only one group of
    float64 spectra per stream at a time."""
    ogg = OggReader(BufferReader(data))
    pk = ogg.packets()
    info = parse_identification(next(pk))
    parse_comment(next(pk))
    setup = parse_setup(next(pk), info.channels)
    dec = PacketDecoder(info, setup)

    def gen():
        for p in pk:
            try:
                r = dec.decode_spectrum(p)
            except VorbisError:
                r = None
            if r is not None:
                yield r

    return info, gen()


def capture_stream(data: bytes):
    """Eager variant of capture_stream_iter (tests, dryrun)."""
    info, gen = capture_stream_iter(data)
    return info, list(gen)


def _group_fn(S: int, G: int, ch: int, bs0: int, bs1: int):
    """Compiled per-group step, vmapped over S streams.

    Inputs  (leading S axis): Xq int16 (S,G,ch,half1), scale f32
    (S,G,ch), onehot f32 (S,G,5), lo int32 (S,G), shift int32 (S,),
    carry f32 (S,ch,half1).
    Returns (pcm16 (S,ch,Lpad) int16, carry' (S,ch,half1) f32); the
    host slices pcm16[:, :, half1:half1+shift] per stream.
    """
    import jax
    import jax.numpy as jnp
    key = (S, G, ch, bs0, bs1)
    if key in _GROUP_JIT:
        return _GROUP_JIT[key]
    half1 = bs1 // 2
    lpad = (G + 3) * half1
    ops = jnp.asarray(_operators(bs0, bs1))
    P = jax.lax.Precision.HIGHEST

    def one(Xq, scale, onehot, lo, shift, carry):
        X = Xq.astype(jnp.float32) * scale[:, :, None]      # (G, ch, h1)
        Y = jnp.zeros((G, ch, bs1), jnp.float32)
        for cid in range(N_CONFIGS):
            Xw = (X * onehot[:, cid][:, None, None]).reshape(G * ch, half1)
            Y = Y + jnp.matmul(Xw, ops[cid],
                               precision=P).reshape(G, ch, bs1)
        # overlap-add: one flat scatter into the group timeline
        idx = ((jnp.arange(ch) * lpad)[None, :, None]
               + lo[:, None, None] + jnp.arange(bs1)[None, None, :])
        out = jnp.zeros((ch * lpad,), jnp.float32)
        out = out.at[idx.reshape(-1)].add(Y.reshape(-1))
        out = out.reshape(ch, lpad)
        # group-to-group lap: carry-in sits at local [half1, 2*half1)
        out = jax.lax.dynamic_update_slice(
            out, out[:, half1:2 * half1] + carry, (0, half1))
        carry_out = jax.lax.dynamic_slice(
            out, (0, half1 + shift), (ch, half1))
        pcm16 = jnp.clip(jnp.round(out * 32768.0), -32768, 32767) \
            .astype(jnp.int16)
        return pcm16, carry_out

    fn = jax.jit(jax.vmap(one))
    _GROUP_JIT[key] = fn
    return fn


def _pack_group(blocks, cursor, bs0: int, bs1: int, ch: int, G: int):
    """blocks: up to G captured blocks continuing a stream whose lap
    walk is at `cursor` = (center, prev_quarter), or None at stream
    start.  Returns (Xq, scale, onehot, lo_abs, center, prev_quarter,
    start_center) host arrays for one stream's group slot; rows past
    len(blocks) are inert (zero onehot/spectra)."""
    half1 = bs1 // 2
    Xq = np.zeros((G, ch, half1), np.int16)
    scale = np.zeros((G, ch), np.float32)
    onehot = np.zeros((G, N_CONFIGS), np.float32)
    lo = np.zeros((G,), np.int64)
    center, prev_quarter = (None, None) if cursor is None else cursor
    start_center = None
    for i, (n, pf, nf, spec) in enumerate(blocks):
        if center is None:
            center = n // 2
            start_center = center
        else:
            center = center + prev_quarter + n // 4
        prev_quarter = n // 4
        onehot[i, _config_id(n, bs1, pf, nf)] = 1.0
        half = n // 2
        mx = np.abs(spec).max(axis=1)                    # (ch,)
        sc_enc = np.where(mx > 0, 32767.0 / np.maximum(mx, 1e-30), 1.0)
        Xq[i, :, :half] = np.clip(
            np.rint(spec * sc_enc[:, None]), -32768, 32767).astype(np.int16)
        scale[i] = (1.0 / sc_enc).astype(np.float32)
        lo[i] = center - half                            # absolute
    return Xq, scale, onehot, lo, center, prev_quarter, start_center


def decode_vorbis_streams_device(streams: list, group: int = 64):
    """Multi-stream serving shape: S Ogg Vorbis streams, entropy on
    host, IMDCT/window/overlap-add batched on device (vmap over
    streams).  Output is [(ch, n) int16] per stream, n = samples from
    the stream's first block center to its last (the host Lapper's
    emission window; granule trimming is CodecVorbis' job)."""
    import itertools
    caps = [capture_stream_iter(s) for s in streams]
    infos = [c[0] for c in caps]
    gens = [c[1] for c in caps]
    bs0, bs1 = infos[0].blocksize
    ch = infos[0].channels
    for inf in infos[1:]:
        if inf.blocksize != (bs0, bs1) or inf.channels != ch:
            raise ValueError("device batch needs uniform blocksizes "
                             "and channel count")
    S = len(caps)
    half1 = bs1 // 2
    fn = _group_fn(S, group, ch, bs0, bs1)
    cursors = [None] * S                  # (center, prev_quarter)
    outs: list[list[np.ndarray]] = [[] for _ in range(S)]
    carry = np.zeros((S, ch, half1), np.float32)
    pending: list = []

    def drain():
        for pcm16, shifts in pending:
            pcm16 = np.asarray(pcm16)
            for s in range(S):
                sh = int(shifts[s])
                if sh > 0:
                    outs[s].append(pcm16[s, :, half1:half1 + sh])
        pending.clear()

    while True:
        any_blocks = False
        Xqs, scales, onehots, los, shifts = [], [], [], [], []
        for s, gen in enumerate(gens):
            blk = list(itertools.islice(gen, group))
            any_blocks = any_blocks or bool(blk)
            Xq, scale, onehot, lo, center, pq, start_c = _pack_group(
                blk, cursors[s], bs0, bs1, ch, group)
            if blk:
                if cursors[s] is None:
                    emit_from = start_c
                else:
                    emit_from = cursors[s][0]
                cursors[s] = (center, pq)
                shift = center - emit_from
            else:
                emit_from = 0 if cursors[s] is None else cursors[s][0]
                shift = 0
            # offsets relative to the group origin (emit_from - half1)
            lo = lo - (emit_from - half1)
            lo[onehot.sum(axis=1) == 0] = 0
            Xqs.append(Xq)
            scales.append(scale)
            onehots.append(onehot)
            los.append(lo.astype(np.int32))
            shifts.append(shift)
        if not any_blocks:
            break
        pcm16, carry = fn(np.stack(Xqs), np.stack(scales),
                          np.stack(onehots), np.stack(los),
                          np.asarray(shifts, np.int32), carry)
        pending.append((pcm16, shifts))
        if len(pending) >= 4:             # bound in-flight downloads
            drain()
    drain()
    return [np.concatenate(o, axis=1) if o else np.zeros((ch, 0), np.int16)
            for o in outs]


def decode_vorbis_stream_device(data: bytes, group: int = 64) -> np.ndarray:
    """Whole-stream device decode of one Ogg Vorbis stream ->
    (ch, n) int16 PCM (synthesis-path surface; see streams variant)."""
    return decode_vorbis_streams_device([data], group=group)[0]
