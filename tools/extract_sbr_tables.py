#!/usr/bin/env python
"""Extract SBR decoder constants into ohpipeline_jax/codecs/aac/sbr_tables.npz.

Two sources, both category-(b) spec/wire constants (like the other codec
table extractions in this repo):
  * huffman code books + noise phase table: parsed from the reference's
    vendored fdk-aac libSBRdec/src/sbr_rom.cpp (ISO/IEC 14496-3 tables
    4.A.74-4.A.88)
  * QMF analysis/synthesis kernels: measured as impulse responses of
    fdk's own filterbank via tools/sbr_probe.cpp — the filterbank is
    linear and shift-invariant, so the (bands x taps) complex kernels are
    exactly the matmul operators the device decoder uses

Run from the repo root after `tools/build_oracles.sh aac` and building
sbr_probe (see build_oracles.sh).
"""

import re
import subprocess
import sys
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = pathlib.Path("/root/reference/thirdparty/fdk-aac/libSBRdec/src")
PROBE = ROOT / ".oracle_build" / "sbr_probe"

BOOKS = [
    ("EnvLevel10T", 120), ("EnvLevel10F", 120),
    ("EnvBalance10T", 48), ("EnvBalance10F", 48),
    ("EnvLevel11T", 62), ("EnvLevel11F", 62),
    ("EnvBalance11T", 24), ("EnvBalance11F", 24),
    ("NoiseLevel11T", 62), ("NoiseBalance11T", 24),
]


def parse_books(text: str) -> dict:
    out = {}
    for name, n in BOOKS:
        m = re.search(
            r"sbr_huffBook_" + name + r"\[" + str(n)
            + r"\]\[2\] = \{(.*?)\};", text, re.S)
        if not m:
            raise SystemExit(f"book {name} not found")
        pairs = re.findall(r"\{\s*(-?\d+),\s*(-?\d+)\s*\}", m.group(1))
        arr = np.asarray([[int(a), int(b)] for a, b in pairs], np.int32)
        assert arr.shape == (n, 2), (name, arr.shape)
        out["huff_" + name] = arr
    return out


PS_BOOKS = [
    ("aBookPsIidTimeDecode", 28), ("aBookPsIidFreqDecode", 28),
    ("aBookPsIccTimeDecode", 14), ("aBookPsIccFreqDecode", 14),
    ("aBookPsIidFineTimeDecode", 60), ("aBookPsIidFineFreqDecode", 60),
]


def parse_ps_books(text: str) -> dict:
    """Parametric-stereo huffman books (ISO 14496-3 tables 8.x, vendored
    fdk sbr_rom.cpp aBookPs*)."""
    out = {}
    for name, n in PS_BOOKS:
        m = re.search(name + r"\[" + str(n) + r"\]\[2\] = \{(.*?)\};",
                      text, re.S)
        if not m:
            raise SystemExit(f"ps book {name} not found")
        pairs = re.findall(r"\{\s*(-?\d+),\s*(-?\d+)\s*\}", m.group(1))
        arr = np.asarray([[int(a), int(b)] for a, b in pairs], np.int32)
        assert arr.shape == (n, 2), (name, arr.shape)
        out["ps_" + name[5:-6]] = arr      # e.g. ps_PsIidTime
    return out


PS_ROMS = [("ScaleFactors", 15), ("ScaleFactorsFine", 31),
           ("Alphas", 8)]


def parse_ps_roms(text: str) -> dict:
    """PS dequantisation ROMs (IID scale factors, ICC rotation
    angles).  Stored right-shifted by one in sbr_rom.cpp:1158-1180;
    exported here as the true float values (x2)."""
    out = {}
    for name, n in PS_ROMS:
        m = re.search(r"const FIXP_DBL " + name + r"\[[^\]]*\] = \{(.*?)\};",
                      text, re.S)
        if not m:
            raise SystemExit(f"ps rom {name} not found")
        vals = re.findall(r"0x([0-9a-fA-F]{8})", m.group(1))
        arr = np.asarray([int(v, 16) for v in vals], np.int64)
        arr = np.where(arr >= 1 << 31, arr - (1 << 32), arr)
        assert arr.size == n, (name, arr.size)
        out["ps_" + name] = arr.astype(np.float64) / (1 << 31) * 2.0
    return out


PS_HEX = [("aAllpassLinkDecaySer", 3),
          ("aaFractDelayPhaseFactorReQmf", 64),
          ("aaFractDelayPhaseFactorImQmf", 64),
          ("aaFractDelayPhaseFactorReSubQmf20", 12),
          ("aaFractDelayPhaseFactorImSubQmf20", 12),
          ("aaFractDelayPhaseFactorSerReQmf", 64 * 3),
          ("aaFractDelayPhaseFactorSerImQmf", 64 * 3),
          ("aaFractDelayPhaseFactorSerReSubQmf20", 12 * 3),
          ("aaFractDelayPhaseFactorSerImSubQmf20", 12 * 3)]


def parse_ps_decorr(text: str) -> dict:
    """PS decorrelator ROMs: allpass decay gains and per-band
    fractional-delay phase factors (Q31 via FXP_CAST), the decay
    scale-factor ramp (float literals) and the long-delay map
    (sbr_rom.cpp:1139-1308)."""
    out = {}
    for name, n in PS_HEX:
        m = re.search(r"const FIXP_PS " + name + r"\[[^=]*= \{(.*?)\};",
                      text, re.S)
        if not m:
            raise SystemExit(f"ps decorr {name} not found")
        vals = re.findall(r"FXP_CAST\(0x([0-9a-fA-F]{8})\)", m.group(1))
        arr = np.asarray([int(v, 16) for v in vals], np.int64)
        arr = np.where(arr >= 1 << 31, arr - (1 << 32), arr)
        assert arr.size == n, (name, arr.size)
        out["ps_" + name] = arr.astype(np.float64) / (1 << 31)
    m = re.search(r"const FIXP_DBL decayScaleFactTable\[64\] = \{(.*?)\};",
                  text, re.S)
    vals = re.findall(r"FL2FXCONST_DBL\((-?\d+\.\d+)\)", m.group(1))
    assert len(vals) == 64
    out["ps_decayScaleFactTable"] = np.asarray([float(v) for v in vals])
    m = re.search(r"const UCHAR delayIndexQmf\[[^=]*= \{(.*?)\};",
                  text, re.S)
    out["ps_delayIndexQmf"] = np.asarray(
        [int(v) for v in re.findall(r"\d+", m.group(1))], np.int64)
    assert out["ps_delayIndexQmf"].size == 64
    return out


def parse_random(text: str) -> np.ndarray:
    m = re.search(r"sbr_randomPhase\[[^\]]*\]\[2\] = \{(.*?)\};", text, re.S)
    if not m:
        raise SystemExit("randomPhase not found")
    vals = re.findall(r"FL2FXCONST_SGL\(\s*(-?\d+\.\d+)f?\s*/\s*8\.0\s*\)",
                      m.group(1))
    arr = np.asarray([float(v) for v in vals], np.float64)
    assert arr.size == 1024, arr.size
    return arr.reshape(512, 2)


def probe_ana(bands: int) -> np.ndarray:
    """(bands, 10*bands) complex analysis kernel: X[k] of the last slot
    for an impulse (value 16384) at each window position."""
    out = subprocess.run([str(PROBE), "ana", str(bands)],
                         capture_output=True, text=True, check=True)
    span = 10 * bands
    K = np.zeros((bands, span), np.complex128)
    for line in out.stdout.splitlines():
        parts = line.split()
        m = int(parts[0])
        vals = np.asarray([int(v) for v in parts[1:]], np.float64)
        K[:, m] = (vals[0::2] + 1j * vals[1::2]) / 16384.0
    return K


def probe_syn(bands: int) -> np.ndarray:
    """(bands, 2, 12*bands) synthesis kernel: time response to a unit
    impulse (value 2**26) in (band, re/im) at slot 0."""
    out = subprocess.run([str(PROBE), "syn", str(bands)],
                         capture_output=True, text=True, check=True)
    K = np.zeros((bands, 2, 12 * bands), np.float64)
    for line in out.stdout.splitlines():
        parts = line.split()
        k, part = int(parts[0]), int(parts[1])
        K[k, part] = np.asarray([int(v) for v in parts[2:]],
                                np.float64) / (1 << 29)
    return K


def main() -> int:
    text = (SRC / "sbr_rom.cpp").read_text(errors="replace")
    tables = parse_books(text)
    tables.update(parse_ps_books(text))
    tables.update(parse_ps_roms(text))
    tables.update(parse_ps_decorr(text))
    tables["random_phase"] = parse_random(text)
    tables["ana32"] = probe_ana(32)
    tables["syn64"] = probe_syn(64)
    out = ROOT / "ohpipeline_jax" / "codecs" / "aac" / "sbr_tables.npz"
    np.savez_compressed(out, **tables)
    print(f"wrote {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
