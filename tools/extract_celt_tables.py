#!/usr/bin/env python
"""Extract the CELT 48 kHz mode tables (band layout, allocation matrix,
PVQ bit cache, window) from the reference's vendored opus via the
celt_probe oracle, into ohpipeline_jax/codecs/opus/celt_mode.npz.

These are wire-format constants of RFC 6716 (the normative decoder); the
decoder logic itself is implemented from the spec in codecs/opus/."""

import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROBE = ROOT / ".oracle_build" / "celt_probe"


def main():
    if not PROBE.exists():
        sys.exit("build celt_probe first (tools/build_oracles.sh opus)")
    m = json.loads(subprocess.run([str(PROBE), "mode", "960"],
                                  capture_output=True,
                                  check=True).stdout)
    nb = m["nbEBands"]
    out = dict(
        overlap=np.int32(m["overlap"]),
        nb_ebands=np.int32(nb),
        eff_ebands=np.int32(m["effEBands"]),
        preemph=np.float64(m["preemph"]),
        max_lm=np.int32(m["maxLM"]),
        short_mdct_size=np.int32(m["shortMdctSize"]),
        nb_short_mdcts=np.int32(m["nbShortMdcts"]),
        ebands=np.asarray(m["eBands"][:nb + 1], np.int16),
        alloc_vectors=np.asarray(m["allocVectors"],
                                 np.uint8).reshape(-1, nb),
        logn=np.asarray(m["logN"], np.int16),
        window=np.asarray(m["window"], np.float64),
        cache_index=np.asarray(m["cache_index"], np.int16),
        cache_bits=np.asarray(m["cache_bits"], np.uint8),
        cache_caps=np.asarray(m["cache_caps"], np.uint8),
    )
    dest = ROOT / "ohpipeline_jax" / "codecs" / "opus" / "celt_mode.npz"
    dest.parent.mkdir(exist_ok=True)
    np.savez_compressed(dest, **out)
    print(f"wrote {dest} ({dest.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
