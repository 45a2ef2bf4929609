#!/usr/bin/env python3
"""Compare the envelope adjuster's gains/noise levels vs fdk's
(instrumented oracle env_calc dump vs sbr.py ENV_SINK tap).

Reports, over all (frame, envelope, bin):
  - gain ratio ours/fdk (dimensionless, directly comparable)
  - noise_rel ratio: (noise/sqrt(ref)) ours vs fdk
  - ref-scale consistency: Emap_ours / nrgRef_fdk (should be one
    global constant = the ENERGY_CAL mapping)
  - est-scale consistency: Ecurr_ours / nrgEst_fdk vs the same
    constant (exposes fdk's nrgEst+1 bias at small energies)

Reference behaviour: fdk-aac/libSBRdec/src/env_calc.cpp:636-905.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
OUT = os.path.join(REPO, ".oracle_build")
ORACLE = os.path.join(OUT, "aac_oracle")
INSTR = os.path.join(OUT, "aac_oracle_instr")


def run(kind):
    from test_sbr import _content
    x = _content(kind)
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        fdec, dump = os.path.join(td, "d.raw"), os.path.join(td, "e.txt")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "48000", "2", "5"], check=True,
                       capture_output=True)
        env = dict(os.environ, SBR_ENV_DUMP=dump)
        subprocess.run([INSTR, "decode", fout, fdec], check=True,
                       capture_output=True, env=env)
        fdk = parse(dump)
        data = open(fout, "rb").read()
    return fdk, data


def parse(path):
    calls = {}
    for line in open(path):
        p = line.split()
        if p[0] != "E":
            continue
        c, e, nsb, lsb = int(p[1]), int(p[2]), int(p[3]), int(p[4])
        v = np.array([float(q) for q in p[5:]]).reshape(nsb, 5)
        calls.setdefault(c, {})[e] = {
            "gain": v[:, 0], "noise": v[:, 1], "sine": v[:, 2],
            "ref": v[:, 3], "est": v[:, 4], "lsb": lsb}
    return calls


def tap_ours(data):
    import ohpipeline_jax.codecs.aac as AAC
    from ohpipeline_jax.codecs.aac import sbr as SBR
    from test_sbr import _decode_he
    sink = []
    SBR.ENV_SINK = sink
    dev = AAC._sbr_decode_frames_device
    AAC._sbr_decode_frames_device = lambda *a, **k: None
    try:
        _decode_he(data)
    finally:
        SBR.ENV_SINK = None
        AAC._sbr_decode_frames_device = dev
    ours = []
    cur = None
    for it in sink:
        if it == "CALL":
            cur = {}
            ours.append(cur)
        else:
            e, gain, noise, sine, emap, ecurr = it[:6]
            cur[e] = {"gain": gain, "noise": noise, "sine": sine,
                      "ref": emap, "est": ecurr}
    return ours


def main():
    kind = sys.argv[1] if len(sys.argv) > 1 else "noise"
    fdk, data = run(kind)
    ours = tap_ours(data)
    print(f"fdk calls {len(fdk)}, our calls {len(ours)}")
    best = None
    for off in range(-6, 7):
        rr = []
        for i, oc in enumerate(ours):
            c = i + off
            if c not in fdk:
                continue
            for e, od in oc.items():
                fd = fdk[c].get(e)
                if fd is None or len(fd["gain"]) != len(od["gain"]):
                    continue
                m = (fd["ref"] > 1e-12) & (od["ref"] > 1e-12)
                rr.extend(np.log(od["ref"][m] / fd["ref"][m]))
        if rr and (best is None or np.var(rr) < best[0]):
            best = (np.var(rr), off)
    off = best[1]
    G, NR, RS, ES, W = [], [], [], [], []
    for i, oc in enumerate(ours):
        c = i + off
        if c not in fdk:
            continue
        for e, od in oc.items():
            fd = fdk[c].get(e)
            if fd is None or len(fd["gain"]) != len(od["gain"]):
                continue
            m = (fd["gain"] > 1e-9) & (od["gain"] > 1e-12) \
                & (fd["ref"] > 1e-12) & (od["ref"] > 1e-12)
            G.extend(od["gain"][m] / fd["gain"][m])
            W.extend(od["ref"][m])
            nrel_f = fd["noise"][m] / np.sqrt(fd["ref"][m])
            nrel_o = od["noise"][m] / np.sqrt(od["ref"][m])
            mm = nrel_f > 1e-9
            NR.extend(nrel_o[mm] / nrel_f[mm])
            RS.extend(od["ref"][m] / fd["ref"][m])
            me = (fd["est"] > 1e-12) & (od["est"] > 1e-15) & m
            ES.extend(od["est"][me] / fd["est"][me])
    for name, arr in [("gain ratio o/f", G), ("noise_rel ratio", NR),
                      ("ref scale o/f", RS), ("est scale o/f", ES)]:
        a = np.array(arr)
        print(f"{name}: n={len(a)} p10 {np.percentile(a, 10):.4g} "
              f"p50 {np.percentile(a, 50):.4g} p90 "
              f"{np.percentile(a, 90):.4g} mean {a.mean():.4g}")
    # energy-weighted gain ratio (what the ear/SNR sees)
    G, W = np.array(G), np.array(W)
    gw = np.sqrt((G ** 2 * W).sum() / W.sum())
    print(f"energy-weighted rms gain ratio: {gw:.4f}  (offset {off})")


if __name__ == "__main__":
    main()
