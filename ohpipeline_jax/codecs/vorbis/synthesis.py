"""Vorbis packet synthesis: mode/mapping decode, channel coupling, floor
dot product, and the IMDCT + lapped window overlap-add.

Spec §4.3; parity: Tremor mapping0.c/synthesis.c/mdct.c/window.c.  The
codec's IMDCT runs on the host as a batched O(n log n) DCT-IV (the same
sign-twiddle folding Tremor's mdct.c uses, here via scipy's FFT-based
DCT-IV in float64) — for the single-stream codec path each group is
small, and a device matmul per group would add a host<->device round
trip for little arithmetic.  The (n/2, n)
matmul operator `_imdct_op` remains for the sharded device pipeline
(parallel/), where the spectra are already device-resident.  Windows and
the variable-lap overlap-add are light host vector math on absolute
sample positions (each block's center P advances by n_prev/4 + n_cur/4; no block
contributes samples before its predecessor's center, so emission trails
one center behind).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import scipy.fft

from .bitreader import EndOfPacket, LsbBitReader, ilog
from .codebook import VorbisError
from .floor import (decode_floor0, decode_floor1, render_curve,
                    render_curve0)
from .headers import Setup, VorbisInfo
from .residue import decode_residue


@functools.lru_cache(maxsize=None)
def _imdct_op(n: int) -> np.ndarray:
    """(n/2, n) inverse-MDCT operator: y[j] = sum_k X[k]
    cos(2pi/n (j + 0.5 + n/4)(k + 0.5))."""
    j = np.arange(n)
    k = np.arange(n // 2)
    return np.cos(2.0 * np.pi / n * (j[None, :] + 0.5 + n / 4.0)
                  * (k[:, None] + 0.5)).astype(np.float32)


def imdct_many(spectra: np.ndarray, n: int) -> np.ndarray:
    """(T, n/2) -> (T, n) time domain, host O(n log n).

    y[j] = sum_k X[k] cos(2pi/n (j+0.5+n/4)(k+0.5)) folds onto DCT-IV:
    with M = n/2 and t = DCT-IV(X) (t[j] = sum X[k] cos(pi/M
    (j+0.5)(k+0.5))), the shift by M/2 plus the transform's antisymmetric
    periodic extension give y = [t[M/2:], -t[::-1], -t[:M/2]]."""
    if spectra.shape[0] == 0:
        return np.zeros((0, n), np.float64)
    M = n // 2
    t = 0.5 * scipy.fft.dct(np.asarray(spectra, np.float64), type=4,
                            axis=-1)
    y = np.empty(spectra.shape[:-1] + (n,), np.float64)
    y[..., :M // 2] = t[..., M // 2:]
    y[..., M // 2:3 * M // 2] = -t[..., ::-1]
    y[..., 3 * M // 2:] = -t[..., :M // 2]
    return y


@functools.lru_cache(maxsize=None)
def _slope(width: int) -> np.ndarray:
    i = np.arange(width)
    return np.sin(0.5 * np.pi
                  * np.sin((i + 0.5) / width * 0.5 * np.pi) ** 2)


@functools.lru_cache(maxsize=None)
def window_vector(n: int, prev_full: bool, next_full: bool,
                  bs0: int) -> np.ndarray:
    """Lapped Vorbis window: slopes of width n/2 (full) or bs0/2 (short
    neighbour), centered at n/4 and 3n/4."""
    w = np.zeros(n)
    lw = n // 2 if prev_full else bs0 // 2
    rw = n // 2 if next_full else bs0 // 2
    ls = n // 4 - lw // 2
    rs = 3 * n // 4 - rw // 2
    w[ls:ls + lw] = _slope(lw)
    w[ls + lw:rs] = 1.0
    w[rs:rs + rw] = _slope(rw)[::-1]
    return w


class PacketDecoder:
    """Entropy + spectral decode of audio packets into per-channel
    spectra; float spectra are accumulated per block size for the device
    IMDCT pass."""

    def __init__(self, info: VorbisInfo, setup: Setup):
        self.info = info
        self.setup = setup
        self._mode_bits = ilog(len(setup.modes) - 1)
        self._native = None
        if not os.environ.get("OHP_VORBIS_PY"):
            from ...native import VorbisNativeCtx
            ctx = VorbisNativeCtx(setup.codebooks)
            if ctx.ok:
                self._native = ctx

    def decode_spectrum(self, packet: bytes):
        """-> (n, prev_full, next_full, spectra (ch, n/2) float64) or
        None for non-audio/undecodable packets."""
        info, setup = self.info, self.setup
        br = LsbBitReader(packet)
        try:
            if br.read(1):
                return None              # not an audio packet
            mode = setup.modes[br.read(self._mode_bits)]
        except (EndOfPacket, IndexError):
            return None
        n = info.blocksize[mode.blockflag]
        prev_full = next_full = True
        if mode.blockflag:
            try:
                prev_full = bool(br.read(1))
                next_full = bool(br.read(1))
            except EndOfPacket:
                return None
        mapping = setup.mappings[mode.mapping]
        half = n // 2
        ch = info.channels
        books = setup.codebooks

        # floors (type 1, and the legacy type-0 LSP floor)
        posts = []
        for c in range(ch):
            kind, fl = setup.floors[mapping.submap_floor[mapping.mux[c]]]
            if kind == 1:
                posts.append(decode_floor1(br, fl, books))
            else:
                posts.append(decode_floor0(br, fl, books))
        no_residue = [p is None for p in posts]
        # nonzero propagation through coupling
        for m, a in mapping.coupling:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = no_residue[a] = False

        # residues per submap
        residue_v = [np.zeros(half, np.float64) for _ in range(ch)]
        for s in range(mapping.submaps):
            chans = [c for c in range(ch) if mapping.mux[c] == s]
            dnd = [no_residue[c] for c in chans]
            res = setup.residues[mapping.submap_residue[s]]
            out = decode_residue(br, res, books, dnd, half,
                                 native=self._native)
            for c, v in zip(chans, out):
                residue_v[c] = v

        # inverse coupling (square polar), reversed order
        for m, a in reversed(mapping.coupling):
            M, A = residue_v[m], residue_v[a]
            apos = A > 0
            msign = np.where(M > 0, 1.0, -1.0)
            new_m = np.where(apos, M, M + msign * A)
            new_a = np.where(apos, M - msign * A, M)
            residue_v[m], residue_v[a] = new_m, new_a

        # floor curve dot product
        spectra = np.zeros((ch, half), np.float64)
        for c in range(ch):
            if posts[c] is None:
                continue
            kind, fl = setup.floors[mapping.submap_floor[mapping.mux[c]]]
            curve = (render_curve(posts[c], fl, half) if kind == 1
                     else render_curve0(posts[c], fl, half))
            spectra[c] = residue_v[c] * curve
        return n, prev_full, next_full, spectra


class Lapper:
    """Windowed overlap-add over absolute sample positions with emission
    trailing the current block center."""

    def __init__(self, channels: int, bs0: int):
        self.ch = channels
        self.bs0 = bs0
        self.buf = np.zeros((channels, 0))
        self.buf_start = 0               # absolute position of buf[:,0]
        self.center = None               # absolute center of last block
        self.emit_pos = None

    def add_block(self, time_block: np.ndarray, n: int, prev_full: bool,
                  next_full: bool) -> np.ndarray:
        """time_block (ch, n) already IMDCT'd.  Returns newly final
        samples (ch, k)."""
        w = window_vector(n, prev_full, next_full, self.bs0)
        if self.center is None:
            self.center = n // 2
            self.emit_pos = self.center
        else:
            self.center += self._prev_quarter + n // 4
        self._prev_quarter = n // 4
        lo = self.center - n // 2
        hi = self.center + n // 2
        # grow the accumulator to cover [buf_start, hi); blocks never
        # reach before the previous center (== buf_start after emission)
        if lo < self.buf_start:
            pad = np.zeros((self.ch, self.buf_start - lo))
            self.buf = np.concatenate([pad, self.buf], axis=1)
            self.buf_start = lo
        need = hi - self.buf_start
        if self.buf.shape[1] < need:
            pad = np.zeros((self.ch, need - self.buf.shape[1]))
            self.buf = np.concatenate([self.buf, pad], axis=1)
        off = lo - self.buf_start
        self.buf[:, off:off + n] += time_block * w[None, :]
        # emit up to the current center, drop the consumed prefix
        a = self.emit_pos - self.buf_start
        b = self.center - self.buf_start
        out = self.buf[:, a:b].copy()
        self.emit_pos = self.center
        self.buf = self.buf[:, b:]
        self.buf_start = self.emit_pos
        return out

    @property
    def emitted(self) -> int:
        return self.emit_pos or 0
