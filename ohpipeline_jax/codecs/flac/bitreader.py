"""MSB-first bit reader/writer for bitstream codecs (FLAC, ALAC, MP3...).

Host-side; the Python implementation is the correctness reference, the C++
unpacker in ohpipeline_jax/native mirrors it for the hot path.  Behavioural
(not code) parity: flac-1.2.1 bitreader.c as driven by the reference's
Flac.cpp adapter.
"""

from __future__ import annotations


class BitReader:
    """Read MSB-first bit fields out of a bytes object."""

    __slots__ = ("data", "pos")   # pos is in bits

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    @property
    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    @property
    def byte_pos(self) -> int:
        return (self.pos + 7) // 8

    def read(self, nbits: int) -> int:
        """Unsigned big-endian field of nbits."""
        if nbits == 0:
            return 0
        pos = self.pos
        end = pos + nbits
        if end > len(self.data) * 8:
            raise EOFError("bitstream exhausted")
        first, last = pos >> 3, (end - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        chunk >>= (last + 1) * 8 - end
        self.pos = end
        return chunk & ((1 << nbits) - 1)

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        return v - (1 << nbits) if v >> (nbits - 1) else v

    def read_unary(self) -> int:
        """Count zero bits until the terminating one bit (Rice quotient)."""
        data, pos = self.data, self.pos
        nbytes = len(data)
        count = 0
        # fast-forward over whole zero bytes
        while True:
            byte_i = pos >> 3
            if byte_i >= nbytes:
                raise EOFError("bitstream exhausted in unary")
            b = data[byte_i]
            rem = 8 - (pos & 7)
            window = b & ((1 << rem) - 1)
            if window == 0:
                count += rem
                pos += rem
                continue
            lead = rem - window.bit_length()
            count += lead
            pos += lead + 1
            self.pos = pos
            return count

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def peek_bits(self, nbits: int) -> int:
        """Read without consuming; short reads at EOS are zero-padded
        (Huffman LUT peeks near stream end)."""
        pos = self.pos
        avail = len(self.data) * 8 - pos
        if avail >= nbits:
            v = self.read(nbits)
            self.pos = pos
            return v
        if avail <= 0:
            return 0
        v = self.read(avail)
        self.pos = pos
        return v << (nbits - avail)

    def skip(self, nbits: int) -> None:
        self.pos += nbits

    def read_rice(self, param: int) -> int:
        """One Rice-coded signed residual (zigzag)."""
        q = self.read_unary()
        v = (q << param) | self.read(param) if param else q
        return (v >> 1) ^ -(v & 1)

    def read_utf8_coded(self, max_bytes: int = 7) -> int:
        """FLAC's UTF-8-style coded number (frame/sample number)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x40
        while b0 & mask:
            n += 1
            mask >>= 1
        if n == 0 or n >= max_bytes:
            raise ValueError("bad UTF-8 coded number")
        v = b0 & (mask - 1)
        for _ in range(n):
            c = self.read(8)
            if c & 0xC0 != 0x80:
                raise ValueError("bad UTF-8 continuation")
            v = (v << 6) | (c & 0x3F)
        return v


class BitWriter:
    """MSB-first bit writer (FLAC encoder, test-vector construction)."""

    __slots__ = ("_acc", "_nbits", "_out")

    def __init__(self):
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def write_rice(self, value: int, param: int) -> None:
        # zigzag: positive v -> 2v, negative v -> -2v-1
        z = (value << 1) if value >= 0 else ((-value << 1) - 1)
        self.write_unary(z >> param)
        if param:
            self.write(z & ((1 << param) - 1), param)

    def write_utf8_coded(self, value: int) -> None:
        if value < 0x80:
            self.write(value, 8)
            return
        payload = []
        n = 1
        while True:
            bits = 6 - n if n < 6 else 0
            total = bits + 6 * n
            if value < (1 << total):
                break
            n += 1
        lead = (0xFF << (7 - n)) & 0xFF
        shift = 6 * n
        self.write(lead | ((value >> shift) & ((1 << (6 - n)) - 1)), 8)
        for i in range(n - 1, -1, -1):
            self.write(0x80 | ((value >> (6 * i)) & 0x3F), 8)

    def align_byte(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned"
        return bytes(self._out)

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits


def crc8(data: bytes, poly: int = 0x07) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


_CRC16_TABLE = None


def crc16(data: bytes, poly: int = 0x8005) -> int:
    """CRC-16 over the frame (FLAC frame footer)."""
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        table = []
        for i in range(256):
            crc = i << 8
            for _ in range(8):
                crc = ((crc << 1) ^ poly) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
            table.append(crc)
        _CRC16_TABLE = table
    crc = 0
    t = _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ t[((crc >> 8) ^ b) & 0xFF]
    return crc
