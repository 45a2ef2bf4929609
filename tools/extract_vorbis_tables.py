#!/usr/bin/env python3
"""Extract the Vorbis floor1 fromdB lookup (ISO-spec constant data) from
the reference's vendored Tremor into codecs/vorbis/tables.npz.

The 256-entry table is the spec's floor1_inverse_dB_table; Tremor stores
it as round(float * 2^31) (floor1.c:232, XdB(n)=(n) at normal accuracy).
Only numeric constant data is extracted — no code.
"""

import pathlib
import re

import numpy as np

REF = pathlib.Path("/root/reference/thirdparty/Tremor")
OUT = (pathlib.Path(__file__).resolve().parent.parent / "ohpipeline_jax"
       / "codecs" / "vorbis" / "tables.npz")


def _ints(text: str, name: str, n: int) -> np.ndarray:
    m = re.search(name + r"\[[^]]*\]=\{(.*?)\};", text, re.S)
    vals = [int(x, 0) for x in re.findall(r"-?(?:0[xX][0-9a-fA-F]+|\d+)",
                                          m.group(1))]
    assert len(vals) == n, (name, len(vals))
    return np.array(vals, np.int64)


def main() -> None:
    text = (REF / "floor1.c").read_text()
    m = re.search(r"FLOOR_fromdB_LOOKUP\[256\]=\{(.*?)\};", text, re.S)
    ints = [int(x, 16) for x in re.findall(r"XdB\(0x([0-9a-fA-F]+)\)",
                                           m.group(1))]
    assert len(ints) == 256, len(ints)
    fromdb = np.array(ints, np.float64) / (1 << 31)
    # floor0 fixed-point lookups (lsp_lookup.h): the reference decoder's
    # LSP-to-curve arithmetic is normative, so its quantized cos /
    # inverse-sqrt / fromdB tables are wire constants
    lsp = (REF / "lsp_lookup.h").read_text()
    cos_i = _ints(lsp, "COS_LOOKUP_I", 129)
    invsq_i = _ints(lsp, r"INVSQ_LOOKUP_I\b", 65)
    invsq_d = _ints(lsp, "INVSQ_LOOKUP_IDel", 64)
    fromdb_i = _ints(lsp, r"FROMdB_LOOKUP\b", 35)
    fromdb2_i = _ints(lsp, "FROMdB2_LOOKUP", 32)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, floor1_fromdb=fromdb,
                        lsp_cos=cos_i, lsp_invsq=invsq_i,
                        lsp_invsq_del=invsq_d, lsp_fromdb=fromdb_i,
                        lsp_fromdb2=fromdb2_i)
    print(f"wrote {OUT}: fromdB[0]={fromdb[0]:.8g} fromdB[255]="
          f"{fromdb[255]:.8g} cos[0]={cos_i[0]} invsq[0]={invsq_i[0]}")


if __name__ == "__main__":
    main()
