#!/usr/bin/env python
"""Recover ISO/IEC 13818-7 / 14496-3 AAC constant tables (spectral and
scalefactor Huffman codebooks, scalefactor-band offsets) as canonical data.

These are standard-mandated constants, identical in every conformant AAC
decoder.  They are decoded out of the vendored reference decoder's
2-bit-parallel walk tables (/root/reference/thirdparty/fdk-aac,
libAACdec/src/aac_rom.cpp) back into canonical (codeword, length, values)
form — pure standard data, free of the source's structure.  Output:
ohpipeline_jax/codecs/aac/tables.npz.
"""

from __future__ import annotations

import pathlib
import re
import sys

import numpy as np

ROM = pathlib.Path("/root/reference/thirdparty/fdk-aac/libAACdec/src/"
                   "aac_rom.cpp")
OUT = pathlib.Path(__file__).resolve().parent.parent / \
    "ohpipeline_jax" / "codecs" / "aac" / "tables.npz"

# (dimension, bits-per-dimension, unsigned-offset) per codebook id —
# ISO 14496-3 Table 4.A.2ff structure
CB_DESC = {1: (4, 2, 1), 2: (4, 2, 1), 3: (4, 2, 0), 4: (4, 2, 0),
           5: (2, 4, 4), 6: (2, 4, 4), 7: (2, 4, 0), 8: (2, 4, 0),
           9: (2, 4, 0), 10: (2, 4, 0), 11: (2, 5, 0)}
SCL_OFFSET = 60


def parse_ushort_tables(src: str) -> dict[str, list[list[int]]]:
    out = {}
    for m in re.finditer(
            r"const USHORT (HuffmanCodeBook_\w+)\[\d+\]\[4\]\s*=\s*\{(.*?)\};",
            src, re.S):
        rows = re.findall(r"\{([^{}]*)\}", m.group(2))
        out[m.group(1)] = [[int(x, 16) for x in
                            re.findall(r"0x[0-9a-fA-F]+", r)] for r in rows]
    return out


def walk(rows: list[list[int]], row: int, prefix: int, nbits: int,
         out: dict) -> None:
    for idx in range(4):
        e = rows[row][idx]
        code = (prefix << 2) | idx
        if e & 1:                      # endnode
            length = nbits + 2 - (0 if not (e & 2) else 1)
            value = e >> 2
            c = code >> (nbits + 2 - length)
            key = (c, length)
            if key in out:
                assert out[key] == value, key
                continue
            out[key] = value
        else:
            walk(rows, (e >> 2), code, nbits + 2, out)


def unpack_value(value: int, dim: int, bits: int, offset: int) -> tuple:
    # low bits hold the FIRST spectral value of the tuple
    vals = []
    for i in range(dim):
        vals.append(((value >> (bits * i)) & ((1 << bits) - 1)) - offset)
    return tuple(vals)


def main() -> int:
    src = ROM.read_text(errors="replace")
    tables = parse_ushort_tables(src)
    data = {}
    for cb, (dim, bits, offset) in CB_DESC.items():
        rows = tables[f"HuffmanCodeBook_{cb}"]
        cw: dict = {}
        walk(rows, 0, 0, 0, cw)
        codes = np.array([c for c, _l in cw], np.uint32)
        lens = np.array([l for _c, l in cw], np.uint8)
        vals = np.array([unpack_value(v, dim, bits, offset)
                         for v in cw.values()], np.int8)
        data[f"cb{cb}_codes"] = codes
        data[f"cb{cb}_lens"] = lens
        data[f"cb{cb}_vals"] = vals
        data[f"cb{cb}_dim"] = np.uint8(dim)
    # scalefactor codebook: dim 1, 8-bit values, offset 60
    rows = tables["HuffmanCodeBook_SCL"]
    cw = {}
    walk(rows, 0, 0, 0, cw)
    data["scl_codes"] = np.array([c for c, _l in cw], np.uint32)
    data["scl_lens"] = np.array([l for _c, l in cw], np.uint8)
    data["scl_vals"] = np.array([v - SCL_OFFSET for v in cw.values()],
                                np.int16)
    # scalefactor band offsets (1024/128 windows), indexed by the standard
    # sampling_frequency_index 0..12 (96k..8k)
    for m in re.finditer(
            r"const SHORT (sfb_\d+_(?:1024|128))\[\d+\]\s*=\s*\{([^}]*)\}",
            src):
        data[m.group(1)] = np.array(
            [int(x) for x in re.findall(r"-?\d+", m.group(2))], np.int16)
    sfb_map = []     # (long_name, short_name) per sampling frequency index
    block = src[src.index("sfbOffsetTables[5][16]"):]
    block = block[: block.index("};")]
    # first 13 rows are the MPEG-4 1024-frame group (96k..8k)
    for m in re.finditer(r"\{\s*(sfb_\w+),\s*(sfb_\w+),\s*(\d+),\s*(\d+)\s*\}",
                         block):
        if len(sfb_map) >= 13:
            break
        sfb_map.append((m.group(1), m.group(2), int(m.group(3)),
                        int(m.group(4))))
    data["sfb_index_long"] = np.array(
        [list(data[l][:nl + 1]) + [0] * (52 - nl - 1)
         for (l, s, nl, ns) in sfb_map], np.int16)
    data["sfb_index_short"] = np.array(
        [list(data[s][:ns + 1]) + [0] * (16 - ns - 1)
         for (l, s, nl, ns) in sfb_map], np.int16)
    data["sfb_counts"] = np.array([(nl, ns) for (l, s, nl, ns) in sfb_map],
                                  np.int16)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {len(sfb_map)} rate entries, "
          f"{len(CB_DESC)} spectral codebooks + SCL")
    return 0


if __name__ == "__main__":
    sys.exit(main())
