#!/usr/bin/env python
"""Recover the ISO/IEC 11172-3 Layer III constant tables (Huffman code
books Table B.7, scalefactor bands Table B.8) as canonical data.

These are standard-mandated constants — identical in every conformant
decoder.  Rather than hand-transcribing them from the spec (error-prone),
this script *decodes* them out of the vendored reference decoder's
multi-level lookup structures (/root/reference/thirdparty/libmad-0.15.1b)
back into canonical (codeword, length, values) form, which is pure
standard data independent of any implementation.  Output:
ohpipeline_jax/codecs/mp3/tables.npz.

Run: python tools/extract_mp3_tables.py  (requires the reference mount)
"""

from __future__ import annotations

import pathlib
import re
import sys

import numpy as np

REF = pathlib.Path("/root/reference/thirdparty/libmad-0.15.1b")
OUT = pathlib.Path(__file__).resolve().parent.parent / \
    "ohpipeline_jax" / "codecs" / "mp3" / "tables.npz"

# spec constants (ISO 11172-3 Table B.7): linbits per table id and the
# start-bits of each lookup table as registered in the decoder
LINBITS = {16: 1, 17: 2, 18: 3, 19: 4, 20: 6, 21: 8, 22: 10, 23: 13,
           24: 4, 25: 5, 26: 6, 27: 7, 28: 8, 29: 9, 30: 11, 31: 13}
TABLE_FOR_ID = {0: "hufftab0", 1: "hufftab1", 2: "hufftab2", 3: "hufftab3",
                5: "hufftab5", 6: "hufftab6", 7: "hufftab7", 8: "hufftab8",
                9: "hufftab9", 10: "hufftab10", 11: "hufftab11",
                12: "hufftab12", 13: "hufftab13", 15: "hufftab15"}
for _i in range(16, 24):
    TABLE_FOR_ID[_i] = "hufftab16"
for _i in range(24, 32):
    TABLE_FOR_ID[_i] = "hufftab24"
START_BITS = {"hufftab0": 0, "hufftab1": 3, "hufftab2": 3, "hufftab3": 3,
              "hufftab5": 3, "hufftab6": 4, "hufftab7": 4, "hufftab8": 4,
              "hufftab9": 4, "hufftab10": 4, "hufftab11": 4, "hufftab12": 4,
              "hufftab13": 4, "hufftab15": 4, "hufftab16": 4, "hufftab24": 4,
              "hufftabA": 4, "hufftabB": 4}


def parse_tables(src: str) -> dict[str, list]:
    """Parse each hufftab definition into a list of ('P', offs, bits) /
    ('V', (values...), hlen) entries (first definition wins if an #if
    provides alternates)."""
    tables: dict[str, list] = {}
    for m in re.finditer(
            r"union huff(?:pair|quad) const (hufftab\w+)\[\]\s*=\s*\{(.*?)\};",
            src, re.S):
        name, body = m.group(1), m.group(2)
        if name in tables:
            continue
        entries = []
        for em in re.finditer(r"(PTR|V)\(([^)]*)\)", body):
            kind, args = em.group(1), [int(a) for a in
                                       em.group(2).split(",")]
            if kind == "PTR":
                entries.append(("P", args[0], args[1]))
            else:
                entries.append(("V", tuple(args[:-1]), args[-1]))
        tables[name] = entries
    return tables


def walk(entries: list, offset: int, bits: int, prefix: int,
         prefix_len: int, out: dict) -> None:
    """Reconstruct canonical codewords from the multi-level LUT."""
    seen = set()
    for idx in range(1 << bits):
        e = entries[offset + idx]
        if e[0] == "P":
            _, offs, sub_bits = e
            walk(entries, offs, sub_bits, (prefix << bits) | idx,
                 prefix_len + bits, out)
        else:
            _, values, hlen = e
            code = (prefix << bits) | idx
            code >>= bits - hlen          # drop don't-care bits
            length = prefix_len + hlen
            key = (code, length)
            if key in seen or key in out:
                assert out.get(key, values) == values, (key, values)
                continue
            seen.add(key)
            out[key] = values


def canonical(name: str, tables: dict) -> dict:
    entries = tables[name]
    bits = START_BITS[name]
    out: dict = {}
    if bits == 0:
        # hufftab0: single V entry, zero-length code
        out[(0, 0)] = entries[0][1]
        return out
    walk(entries, 0, bits, 0, 0, out)
    return out


def parse_sfb(src: str) -> dict[str, list[int]]:
    sfb = {}
    for m in re.finditer(
            r"unsigned char const (sfb_\w+)\[\]\s*=\s*\{([^}]*)\}", src):
        sfb[m.group(1)] = [int(x) for x in
                           re.findall(r"\d+", m.group(2))]
    for m in re.finditer(r"#\s*define\s+(sfb_\w+)\s+(sfb_\w+)", src):
        alias, target = m.group(1), m.group(2)
        if target in sfb:
            sfb[alias] = sfb[target]
    return sfb


def extract_synthesis_window() -> np.ndarray:
    """Reconstruct ISO 11172-3 Table B.3 (the 512-tap synthesis window).

    The reference stores rows k=0..16 of D[k + 32j]; the remainder follows
    from the window's exact odd symmetry D[i] = -D[512-i] (verified on the
    overlapping row: every known pair matches to the last digit).
    """
    src = (REF / "D.dat").read_text(errors="replace")
    vals = [float(v) for v in
            re.findall(r"/\*\s*(-?\d+\.\d+)\s*\*/", src)]
    rows = [vals[i:i + 32] for i in range(0, len(vals), 32)]
    D = np.zeros(512)
    for k in range(17):
        for j in range(16):
            D[k + 32 * j] = rows[k][j]
    for k in range(17, 32):
        for j in range(16):
            D[k + 32 * j] = -rows[32 - k][15 - j]
    return D


def main() -> int:
    huff_src = (REF / "huffman.c").read_text()
    layer3_src = (REF / "layer3.c").read_text()
    tables = parse_tables(huff_src)
    data = {}
    for tid, tname in TABLE_FOR_ID.items():
        cb = canonical(tname, tables)
        codes = np.array([c for c, _l in cb], np.uint32)
        lens = np.array([l for _c, l in cb], np.uint8)
        vals = np.array([cb[k] for k in cb], np.uint8)   # (n, 2)
        data[f"pair{tid}_codes"] = codes
        data[f"pair{tid}_lens"] = lens
        data[f"pair{tid}_vals"] = vals
        data[f"pair{tid}_linbits"] = np.uint8(LINBITS.get(tid, 0))
    for qname, qkey in (("hufftabA", "quadA"), ("hufftabB", "quadB")):
        cb = canonical(qname, tables)
        data[f"{qkey}_codes"] = np.array([c for c, _l in cb], np.uint32)
        data[f"{qkey}_lens"] = np.array([l for _c, l in cb], np.uint8)
        data[f"{qkey}_vals"] = np.array([cb[k] for k in cb], np.uint8)
    for name, vals in parse_sfb(layer3_src).items():
        data[name] = np.array(vals, np.uint16)
    data["synthesis_window"] = extract_synthesis_window()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **data)
    npair = sum(1 for k in data if k.endswith("_codes"))
    print(f"wrote {OUT} ({npair} codebooks, "
          f"{sum(1 for k in data if k.startswith('sfb'))} sfb tables)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
