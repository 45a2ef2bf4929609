"""Minimal Vorbis stream builder — the conformance-vector source.

Builds spec-valid Ogg Vorbis streams with self-designed codebooks, a
two-post floor, and a type-2 residue carrying chosen small integers.
This gives the test suite bitstreams exercising stereo coupling, window
transitions (two block sizes), and the VQ/classification machinery, all
cross-decodable by the Tremor oracle (no Vorbis encoder exists on this
system).  Spec §4/§5 bit layout; LSB-first packing throughout.
"""

from __future__ import annotations

import numpy as np

from ...containers.ogg import build_pages
from .codebook import assign_codewords, _reverse_bits


class LsbBitWriter:
    def __init__(self):
        self._val = 0
        self._bits = 0

    def write(self, value: int, n: int) -> None:
        self._val |= (value & ((1 << n) - 1)) << self._bits
        self._bits += n

    def getvalue(self) -> bytes:
        nbytes = (self._bits + 7) // 8
        return self._val.to_bytes(nbytes, "little") if nbytes else b""


def _float32_pack(v: float) -> int:
    """Inverse of bitreader.float32_unpack for small integral values."""
    sign = 0
    if v < 0:
        sign = 1 << 31
        v = -v
    if v == 0:
        return 0
    exp = 788
    mant = v
    while mant != int(mant):
        mant *= 2
        exp -= 1
    mant = int(mant)
    while mant >= (1 << 21):
        mant >>= 1
        exp += 1
    return sign | (exp << 21) | mant


def _complete_lengths(n: int) -> list[int]:
    """Lengths for n entries forming a complete prefix code (Kraft = 1):
    depth d = ceil(log2 n); split (n - 2^(d-1)) leaves one level down."""
    if n == 1:
        return [1]
    d = (n - 1).bit_length()
    short = (1 << d) - n              # entries kept at depth d-1... solve:
    # k entries at depth d-1, (n-k) at depth d: k/2^(d-1) + (n-k)/2^d = 1
    k = (1 << d) - n
    return [d - 1] * k + [d] * (n - k)


class BookSpec:
    """A codebook design: lengths + optional type-2 direct VQ values."""

    def __init__(self, dims: int, entries: int,
                 values: np.ndarray | None = None,
                 value_bits: int = 0, minimum: float = 0.0,
                 delta: float = 1.0):
        self.dims = dims
        self.entries = entries
        self.lengths = _complete_lengths(entries)
        self.codes = assign_codewords(self.lengths)
        self.values = values              # (entries, dims) ints >= 0 scaled
        self.value_bits = value_bits
        self.minimum = minimum
        self.delta = delta

    def write(self, bw: LsbBitWriter) -> None:
        bw.write(0x564342, 24)
        bw.write(self.dims, 16)
        bw.write(self.entries, 24)
        bw.write(0, 1)                    # not ordered
        bw.write(0, 1)                    # not sparse
        for l in self.lengths:
            bw.write(l - 1, 5)
        if self.values is None:
            bw.write(0, 4)                # lookup type 0
            return
        bw.write(2, 4)                    # direct lookup
        bw.write(_float32_pack(self.minimum), 32)
        bw.write(_float32_pack(self.delta), 32)
        bw.write(self.value_bits - 1, 4)
        bw.write(0, 1)                    # sequence_p off
        for e in range(self.entries):
            for d in range(self.dims):
                bw.write(int(self.values[e, d]), self.value_bits)

    def write_code(self, bw: LsbBitWriter, entry: int) -> None:
        bw.write(_reverse_bits(self.codes[entry], self.lengths[entry]),
                 self.lengths[entry])


class StreamSpec:
    """Fixed layout: book0 = classbook (dims 2, scalar), book1 = VQ book
    (dims 2, values -2..2), one two-post floor (no partition books), one
    type-2 residue, one mapping (optional coupling), two modes
    (short/long)."""

    PSIZE = 32

    def __init__(self, channels: int = 1, sample_rate: int = 44100,
                 bs0: int = 256, bs1: int = 1024, coupling: bool = False):
        self.ch = channels
        self.rate = sample_rate
        self.bs = (bs0, bs1)
        # floor x domain must cover the long half-spectrum: the
        # beyond-last-post tail is a decoder-divergent path (Tremor
        # multiplies by the raw dB index there; libvorbis by its dB
        # lookup) that real encoders never emit
        self.RANGEBITS = (bs1 // 2).bit_length() - 1
        self.coupling = coupling and channels == 2
        vals = np.array([[a, b] for a in range(5) for b in range(5)])
        self.classbook = BookSpec(2, 4)   # 2 classes, classword dim 2
        self.vqbook = BookSpec(2, 25, values=vals, value_bits=3,
                               minimum=-2.0, delta=1.0)

    # -- headers ------------------------------------------------------------
    def id_packet(self) -> bytes:
        bw = LsbBitWriter()
        for b in b"\x01vorbis":
            bw.write(b, 8)
        bw.write(0, 32)
        bw.write(self.ch, 8)
        bw.write(self.rate, 32)
        bw.write(0, 32)
        bw.write(128000, 32)
        bw.write(0, 32)
        bw.write(self.bs[0].bit_length() - 1, 4)
        bw.write(self.bs[1].bit_length() - 1, 4)
        bw.write(1, 1)
        return bw.getvalue()

    def comment_packet(self) -> bytes:
        vendor = b"ohpipeline-jax test vectors"
        out = b"\x03vorbis"
        out += len(vendor).to_bytes(4, "little") + vendor
        out += (0).to_bytes(4, "little")
        out += b"\x01"
        return out

    def _write_floor_setup(self, bw: LsbBitWriter) -> None:
        bw.write(1, 16)                   # floor type 1
        bw.write(0, 5)                    # 0 partitions
        bw.write(1 - 1, 2)                # multiplier 1 (range 256)
        bw.write(self.RANGEBITS, 4)

    def _books(self) -> list:
        return [self.classbook, self.vqbook]

    def _write_floor_packet(self, bw: LsbBitWriter, c: int,
                            floor_y: list) -> None:
        bw.write(1, 1)                    # floor nonzero
        y0, y1 = floor_y[c]
        bw.write(y0, 8)                   # ilog(255) = 8 bits
        bw.write(y1, 8)

    def setup_packet(self) -> bytes:
        bw = LsbBitWriter()
        for b in b"\x05vorbis":
            bw.write(b, 8)
        books = self._books()
        bw.write(len(books) - 1, 8)
        for b in books:
            b.write(bw)
        bw.write(0, 6)                    # 1 time transform
        bw.write(0, 16)
        bw.write(0, 6)                    # 1 floor
        self._write_floor_setup(bw)
        bw.write(0, 6)                    # 1 residue
        bw.write(2, 16)                   # residue type 2
        bw.write(0, 24)                   # begin
        bw.write(self.ch * self.bs[1] // 2, 24)   # end (clamped per block)
        bw.write(self.PSIZE - 1, 24)
        bw.write(2 - 1, 6)                # 2 classifications
        bw.write(0, 8)                    # classbook = book 0
        # cascade: class 0 -> no passes, class 1 -> pass 0
        bw.write(0, 3)
        bw.write(0, 1)
        bw.write(1, 3)
        bw.write(0, 1)
        bw.write(1, 8)                    # class 1 pass 0 book = book 1
        bw.write(0, 6)                    # 1 mapping
        bw.write(0, 16)                   # mapping type 0
        bw.write(0, 1)                    # submaps flag: 1 submap
        if self.coupling:
            bw.write(1, 1)
            bw.write(0, 8)                # 1 step
            bw.write(0, 1)                # magnitude = ch 0 (ilog(1)=1 bit)
            bw.write(1, 1)                # angle = ch 1
        else:
            bw.write(0, 1)
        bw.write(0, 2)                    # reserved
        bw.write(0, 8)                    # time config (unused)
        bw.write(0, 8)                    # floor 0
        bw.write(0, 8)                    # residue 0
        bw.write(2 - 1, 6)                # 2 modes
        bw.write(0, 1)                    # mode 0: short
        bw.write(0, 16)
        bw.write(0, 16)
        bw.write(0, 8)
        bw.write(1, 1)                    # mode 1: long
        bw.write(0, 16)
        bw.write(0, 16)
        bw.write(0, 8)
        bw.write(1, 1)                    # framing
        return bw.getvalue()

    # -- audio --------------------------------------------------------------
    def audio_packet(self, long_block: bool, prev_long: bool,
                     next_long: bool, floor_y: list[int],
                     residues: np.ndarray) -> bytes:
        """floor_y: per channel (y0, y1) posts in [0, 255] dB units;
        residues: (ch, n/2) ints in [-2, 2] (pre-coupling vectors)."""
        n = self.bs[1] if long_block else self.bs[0]
        half = n // 2
        bw = LsbBitWriter()
        bw.write(0, 1)                    # audio packet
        bw.write(1 if long_block else 0, 1)
        if long_block:
            bw.write(1 if prev_long else 0, 1)
            bw.write(1 if next_long else 0, 1)
        for c in range(self.ch):
            self._write_floor_packet(bw, c, floor_y)
        # residue type 2: interleave channels
        inter = np.zeros(self.ch * half, np.int64)
        for c in range(self.ch):
            inter[c::self.ch] = residues[c]
        nparts = (self.ch * half) // self.PSIZE
        classes = [1 if np.any(inter[p * self.PSIZE:(p + 1) * self.PSIZE])
                   else 0 for p in range(nparts)]
        cw = self.classbook.dims
        p = 0
        while p < nparts:
            temp = 0
            for i in range(cw):
                cls = classes[p + i] if p + i < nparts else 0
                temp = temp * 2 + cls
            self.classbook.write_code(bw, temp)
            for i in range(cw):
                if p >= nparts:
                    break
                if classes[p]:
                    seg = inter[p * self.PSIZE:(p + 1) * self.PSIZE]
                    for j in range(0, self.PSIZE, 2):
                        entry = int((seg[j] + 2) * 5 + (seg[j + 1] + 2))
                        self.vqbook.write_code(bw, entry)
                p += 1
        return bw.getvalue()

    def build(self, blocks: list[tuple[bool, list, np.ndarray]],
              serial: int = 777) -> bytes:
        """blocks: [(long?, floor_y, residues)] -> complete Ogg stream."""
        packets = [self.id_packet()]
        head2 = [self.comment_packet(), self.setup_packet()]
        audio = []
        sizes = [self.bs[1] if b[0] else self.bs[0] for b in blocks]
        for i, (lng, fy, res) in enumerate(blocks):
            prev_long = blocks[i - 1][0] if i > 0 else True
            next_long = blocks[i + 1][0] if i + 1 < len(blocks) else True
            audio.append(self.audio_packet(lng, prev_long, next_long,
                                           fy, res))
        # granule = emitted samples = sum of inter-center gaps
        granule = 0
        for i in range(1, len(sizes)):
            granule += sizes[i - 1] // 4 + sizes[i] // 4
        data = build_pages(serial, [packets[0]], first_sequence=0,
                           bos=True)
        seq = data.count(b"OggS")
        more = build_pages(serial, head2, first_sequence=seq)
        data += more
        seq += more.count(b"OggS")
        data += build_pages(serial, audio, first_sequence=seq,
                            granule=granule, eos=True)
        return data


class StreamSpecFloor0(StreamSpec):
    """StreamSpec variant with the legacy type-0 LSP floor (spec s6.2):
    order-8 LSP coefficients from a dedicated dim-4 type-2 VQ book.
    floor_y entries in audio packets are (amplitude, [entry0, entry1])."""

    ORDER = 8
    AMP_BITS = 6
    AMP_OFFSET = 20
    BARK_MAP = 64

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # LSP roots spread over (0, pi); any two-vector combination
        # (second vector rides on the first's last element) stays < pi,
        # inside Tremor's cos lookup domain
        # roots deliberately OFF the bark grid points (pi*k/BARK_MAP):
        # a root exactly on a grid omega is a numerics pathology where
        # fixed-point (Tremor) and float resonances diverge unboundedly
        vals = np.array([[0, 1, 2, 3], [1, 2, 3, 4],
                         [2, 3, 4, 5], [4, 5, 6, 7]])
        self.lspbook = BookSpec(4, 4, values=vals, value_bits=3,
                                minimum=0.171, delta=0.173)

    def _books(self) -> list:
        return [self.classbook, self.vqbook, self.lspbook]

    def _write_floor_setup(self, bw: LsbBitWriter) -> None:
        bw.write(0, 16)                   # floor type 0
        bw.write(self.ORDER, 8)
        bw.write(self.rate, 16)
        bw.write(self.BARK_MAP, 16)
        bw.write(self.AMP_BITS, 6)
        bw.write(self.AMP_OFFSET, 8)
        bw.write(0, 4)                    # 1 book
        bw.write(2, 8)                    # LSP book index

    def _write_floor_packet(self, bw: LsbBitWriter, c: int,
                            floor_y: list) -> None:
        amplitude, entries = floor_y[c]
        bw.write(amplitude, self.AMP_BITS)
        bw.write(0, 1)                    # book 0 (ilog(1) = 1 bit)
        for e in entries:
            self.lspbook.write_code(bw, e)
