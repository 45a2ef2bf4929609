#!/usr/bin/env python
"""Extract the SILK decoder's constant tables into
ohpipeline_jax/codecs/opus/silk_tables.npz.

The tables (iCDFs, NLSF codebooks, LTP filters, pitch-lag contours,
pulse-count distributions) are normative RFC 6716 section-4.2 constants;
they are parsed mechanically from the reference's vendored
opus-1.5.2/silk/tables_*.c — category-(b) spec constants, the same
approach as the other codec table extractions in this repo.
"""

import pathlib
import re
import sys

import numpy as np

SRC = pathlib.Path("/root/reference/thirdparty/opus-1.5.2/silk")
OUT = (pathlib.Path(__file__).resolve().parent.parent
       / "ohpipeline_jax" / "codecs" / "opus" / "silk_tables.npz")

FILES = [
    "tables_gain.c", "tables_LTP.c", "tables_NLSF_CB_NB_MB.c",
    "tables_NLSF_CB_WB.c", "tables_other.c", "tables_pitch_lag.c",
    "tables_pulses_per_block.c", "table_LSF_cos.c",
    "pitch_est_tables.c", "resampler_rom.c",
]

ARRAY_RE = re.compile(
    r"const\s+(?:opus_)?(u?int\d+|opus_u?int\d+)\s+"
    r"silk_(\w+?)\s*\[[^]]*\]\s*(?:\[[^]]*\]\s*)?=\s*\{(.*?)\};",
    re.S)


def parse_values(body: str) -> np.ndarray:
    body = re.sub(r"/\*.*?\*/", "", body, flags=re.S)
    vals = re.findall(r"-?\d+", body)
    return np.asarray([int(v) for v in vals], np.int64)


def main() -> int:
    tables = {}
    for fname in FILES:
        text = (SRC / fname).read_text(errors="replace")
        for m in ARRAY_RE.finditer(text):
            name = m.group(2)
            arr = parse_values(m.group(3))
            if arr.size == 0:
                continue
            tables[name] = arr
    if len(tables) < 40:
        raise SystemExit(f"only {len(tables)} tables parsed — check regex")
    np.savez_compressed(OUT, **tables)
    print(f"wrote {OUT} ({len(tables)} tables, {OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
