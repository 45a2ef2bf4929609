#!/usr/bin/env python3
"""Measure the SBR transposer's fixed-vs-float LPC gap (diagnostic).

Pipeline:
  1. encode noise/mix content HE-AAC via the oracle encoder
  2. decode with aac_oracle_instr (SBR_LPC_DUMP) -> fdk's per-(call,
     band) fixed-point alphas + the exact scaled int32 lowBand inputs
  3. re-derive alphas two ways from fdk's own inputs:
       - float64 covariance solve (the repo's current host math)
       - the int fixed-point emulation in codecs/aac/sbr_fixlpc.py
     and report agreement with fdk's true alphas.

If the emulation is bit-exact and the float solve is not, transcribing
the fixed-point chain into the decoders closes the conformance gap.
Reference behaviour: fdk-aac/libSBRdec/src/lpp_tran.cpp:371-520,
libFDK/src/autocorr2nd.cpp:185-280.
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


def run_dump(kind: str):
    from test_sbr import _content  # noqa: E402
    x = _content(kind)
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        fdec = os.path.join(td, "d.raw")
        dump = os.path.join(td, "lpc.txt")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "48000", "2", "5"], check=True,
                       capture_output=True)
        env = dict(os.environ, SBR_LPC_DUMP=dump)
        subprocess.run([INSTR, "decode", fout, fdec], check=True,
                       capture_output=True, env=env)
        return parse_dump(dump), open(fout, "rb").read()


def parse_dump(path):
    calls = {}
    for line in open(path):
        p = line.split()
        if p[0] == "B":
            c = int(p[1])
            calls[c] = {"slots": (int(p[2]), int(p[3])),
                        "bw": np.array([int(v) for v in p[4:]]),
                        "bands": {}}
        elif p[0] == "A":
            c, b = int(p[1]), int(p[2])
            calls[c]["bands"][b] = {
                "alpha": np.array([int(v) for v in p[3:7]]),
                "reset": int(p[7]), "dyn": int(p[8]),
                "ovs": int(p[9]), "lbs": int(p[10]),
                "com": int(p[11])}
        elif p[0] == "X":
            c, b = int(p[1]), int(p[2])
            v = np.array([int(q) for q in p[3:]], np.int64)
            calls[c]["bands"][b]["x"] = v[0::2] + 1j * v[1::2]
    return calls


def float_alphas(z):
    """The repo's current float covariance solve (sbr.py:1235-1249)."""
    x0, x1, x2 = z[2:], z[1:-1], z[:-2]
    phi01 = np.vdot(x1, x0)
    phi02 = np.vdot(x2, x0)
    phi11 = np.vdot(x1, x1).real
    phi12 = np.vdot(x2, x1)
    phi22 = np.vdot(x2, x2).real
    d = phi22 * phi11 - abs(phi12) ** 2 / 1.000001
    a1 = (phi01 * phi12 - phi02 * phi11) / d if abs(d) > 1e-9 else 0.0
    a0 = -(phi01 + a1 * np.conj(phi12)) / phi11 if phi11 > 1e-9 else 0.0
    if abs(a0) >= 4 or abs(a1) >= 4:
        a0 = a1 = 0.0
    return a0, a1


def ours_vs_fdk(calls, data):
    """Decode the same ADTS stream with the host decoder, tap its
    transposer alphas, align to the fdk dump and report divergence."""
    import ohpipeline_jax.codecs.aac as AAC
    from ohpipeline_jax.codecs.aac import sbr as SBR
    from test_sbr import _decode_he
    sink = []
    SBR.ALPHA_SINK = sink
    dev = AAC._sbr_decode_frames_device
    AAC._sbr_decode_frames_device = lambda *a, **k: None  # host path
    try:
        _decode_he(data)
    finally:
        SBR.ALPHA_SINK = None
        AAC._sbr_decode_frames_device = dev
    # fdk calls are per (frame, channel) in decode order; so is the tap.
    # find the constant call offset by best global agreement
    fcalls = sorted(calls)
    best = None
    for off in range(-6, 7):
        errs = []
        for i, (ch, al, _zs) in enumerate(sink):
            c = i + off
            if c not in calls:
                continue
            for b, (a0, a1) in al.items():
                bd = calls[c]["bands"].get(b)
                if bd is None:
                    continue
                ref = bd["alpha"].astype(np.float64) * 4 / 32768.0
                errs.append(abs(np.array([a0.real, a0.imag,
                                          a1.real, a1.imag])
                                - ref).max())
        if errs and (best is None or np.mean(errs) < best[0]):
            best = (np.mean(errs), off, np.array(errs))
    mean, off, e = best
    print(f"ours-vs-fdk (offset {off}, {len(e)} pairs): mean "
          f"{mean:.5f} p50 {np.percentile(e, 50):.5f} p90 "
          f"{np.percentile(e, 90):.5f} p99 {np.percentile(e, 99):.5f} "
          f"max {e.max():.4f}")
    print(f"fdk calls {len(fcalls)}, our frames {len(sink)}")
    # decisive experiment: project OUR float z onto fdk's int32 lattice
    # (per-pair fitted scale) and run the fixed-point emulation on it —
    # if those alphas track fdk's, the transcription closes the gap
    from ohpipeline_jax.codecs.aac.sbr_fixlpc import fix_alphas
    nout = 0
    rel, fx_err = [], []
    for i, (ch, al, zs) in enumerate(sink):
        c = i + off
        if c not in calls:
            continue
        for b, (a0, a1) in al.items():
            bd = calls[c]["bands"].get(b)
            if bd is None or b not in zs:
                continue
            ref = bd["alpha"].astype(np.float64) * 4 / 32768.0
            err = abs(np.array([a0.real, a0.imag, a1.real, a1.imag])
                      - ref).max()
            zf = bd["x"].astype(np.complex128)
            zo = zs[b]
            den = (zf * zf.conj()).real.sum()
            s = (zo * zf.conj()).real.sum() / max(den, 1e-30)
            if s <= 0 or den < 1:
                continue
            rr = np.sqrt((abs(zo - s * zf) ** 2).sum()
                         / max((abs(zo) ** 2).sum(), 1e-30))
            rel.append(rr)
            zq = np.round(zo / s)
            fx = fix_alphas(zq.real.astype(np.int64),
                            zq.imag.astype(np.int64),
                            bd["com"] + bd["dyn"])
            fxa = np.array(fx[:4], np.float64) * 4 / 32768.0
            fe = abs(fxa - ref).max()
            fx_err.append(fe)
            if err <= 0.01:
                continue
            nout += 1
            print(f"OUT c={c} b={b} err={err:.3f} fdk_reset="
                  f"{bd['reset']} fdk=({ref[0]:.3f},{ref[1]:.3f},"
                  f"{ref[2]:.3f},{ref[3]:.3f}) ours=({a0.real:.3f},"
                  f"{a0.imag:.3f},{a1.real:.3f},{a1.imag:.3f}) "
                  f"zrel={rr:.2e} fix_from_ours_err={fe:.4f} "
                  f"fix_reset={bool(fx[4])}")
    rel, fx = np.array(rel), np.array(fx_err)
    print(f"outliers(err>0.01): {nout}")
    print(f"z rel diff: p50 {np.percentile(rel, 50):.2e} p99 "
          f"{np.percentile(rel, 99):.2e} max {rel.max():.2e}")
    print(f"fix-from-OUR-inputs alpha err: mean {fx.mean():.5f} p99 "
          f"{np.percentile(fx, 99):.5f} max {fx.max():.4f} "
          f"n>{0.01}: {(fx > 0.01).sum()}")


def main():
    kind = sys.argv[1] if len(sys.argv) > 1 else "noise"
    from ohpipeline_jax.codecs.aac.sbr_fixlpc import fix_alphas
    calls, data = run_dump(kind)
    n = exact = 0
    fl_err, fx_err = [], []
    for c, cd in calls.items():
        for b, bd in cd["bands"].items():
            if "x" not in bd:
                continue
            z = bd["x"]
            n += 1
            a0r, a0i, a1r, a1i, reset = fix_alphas(
                z.real.astype(np.int64), z.imag.astype(np.int64),
                bd["com"] + bd["dyn"])
            got = np.array([a0r, a0i, a1r, a1i])
            if np.array_equal(got, bd["alpha"]) \
                    and bool(reset) == bool(bd["reset"]):
                exact += 1
            elif n - exact <= 10:
                print("MISMATCH", c, b, got, bd["alpha"],
                      reset, bd["reset"])
            # float solve on the same ints
            fa0, fa1 = float_alphas(z.astype(np.complex128))
            ref = bd["alpha"].astype(np.float64) * 4 / 32768.0
            fl_err.append(abs(np.array([fa0.real, fa0.imag,
                                        fa1.real, fa1.imag])
                              - ref).max())
            fx_err.append(abs(got * 4 / 32768.0 - ref).max())
    fl = np.array(fl_err)
    print(f"{kind}: {n} (call,band) pairs; fixed-emulation exact: "
          f"{exact}/{n}")
    print(f"float-vs-fdk alpha |err|: mean {fl.mean():.5f} "
          f"p50 {np.percentile(fl, 50):.5f} p90 "
          f"{np.percentile(fl, 90):.5f} p99 {np.percentile(fl, 99):.5f} "
          f"max {fl.max():.4f}")
    ours_vs_fdk(calls, data)


if __name__ == "__main__":
    main()
