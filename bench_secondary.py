#!/usr/bin/env python
"""Per-codec realtime-x throughput for the codecs outside the headline
FLAC+AAC-LC device metric (bench.py).

The reference's floor is >= 1x realtime for EVERY codec on armv6-class
CPUs (/root/reference/README:27 — ohPipeline runs complete renderers on
such hardware).  This bench documents where this framework's host-side
decoders stand on one CPU core and, for HE-AAC, what the batched device
SBR path (codecs/aac/sbr_jax.py) adds.

Writes BENCH_SECONDARY.json and prints ONE JSON line:
  {"metric": "secondary_codecs_realtime_x", "codecs": {name: x, ...},
   "floor": <min x>, "all_above_realtime": bool}

Content is generated and encoded with the conformance oracles
(.oracle_build/, tools/build_oracles.sh); encodes cache in
.bench_cache/.  Decode wall time covers the full package path
(container parse -> entropy decode -> synthesis -> PCM).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OR = os.path.join(HERE, ".oracle_build")
CACHE = os.path.join(HERE, ".bench_cache")
SECONDS = float(os.environ.get("BENCH2_SECONDS", "20"))


def _content(seconds: float, rate: int = 44100, stereo: bool = True):
    t = np.arange(int(rate * seconds)) / rate
    rng = np.random.default_rng(23)
    x = (np.sin(2 * np.pi * 523 * t) * 9000
         * (0.6 + 0.4 * np.sin(2 * np.pi * 0.9 * t))
         + np.sin(2 * np.pi * 3200 * t) * 3000
         + rng.standard_normal(len(t)) * 900)
    x = np.clip(x, -32000, 32000)
    if stereo:
        return np.stack([x, np.roll(x, 29)]).astype(np.int16)
    return x[None, :].astype(np.int16)


def _cached(name: str, build) -> bytes:
    os.makedirs(CACHE, exist_ok=True)
    key = hashlib.sha1(f"bench2:{name}:{SECONDS}".encode()).hexdigest()
    path = os.path.join(CACHE, key + ".bin")
    if os.path.exists(path):
        return open(path, "rb").read()
    data = build()
    with open(path, "wb") as f:
        f.write(data)
    return data


def _oracle_encode(oracle: str, pcm: np.ndarray, args: list) -> bytes:
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.bin")
        np.ascontiguousarray(pcm.T).tofile(fin)
        subprocess.run([os.path.join(OR, oracle), "encode", fin, fout,
                        *args], check=True, capture_output=True)
        return open(fout, "rb").read()


def bench_one(name: str, data: bytes, decode, audio_s: float,
              passes: int = 3) -> float:
    best = 1e9
    for _ in range(passes):
        t0 = time.perf_counter()
        decode(data)
        best = min(best, time.perf_counter() - t0)
    return audio_s / best


def floor_probe(passes: int = 2) -> dict:
    """Compact serving-floor probe: the four 16-stream *device* serving
    paths (CELT, HE-AAC, MP3, Vorbis), cached content, ``passes``
    timed passes each.  Returns {"codecs": {...}, "floor": min_x}.
    Reuses main()'s .bench_cache keys, so the sweep and the probe share
    encodes; compiled programs come from the persistent jit cache.
    bench.py folds this into the headline JSON as ``secondary_floor``
    when its deadline allows (round-5 verdict #7)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from oracles import ensure_oracles
    if not ensure_oracles():
        return {"codecs": {}, "floor": 0.0, "error": "oracles"}
    secs = SECONDS
    out: dict = {"codecs": {}}

    def timed(fn, audio_of):
        best = 1e9
        res = None
        for _ in range(max(1, passes)):
            t0 = time.perf_counter()
            res = fn()
            best = min(best, time.perf_counter() - t0)
        return audio_of(res) / best

    try:
        from ohpipeline_jax.codecs.opus import celt_jax
        streams = []
        for i in range(16):
            def b(i=i):
                pcm = _content(secs, 48000, stereo=True)
                pcm = np.roll(pcm, 31 * i, axis=1)
                return _oracle_encode("opus_oracle", pcm,
                                      ["2", "96000", "celt"])
            streams.append(_cached(f"opus_celt16_{i}", b))
        celt_jax.decode_celt_streams_device(streams)          # warm
        out["codecs"]["opus_celt_16stream_device"] = timed(
            lambda: celt_jax.decode_celt_streams_device(streams),
            lambda o: o.shape[0] * o.shape[2] / 48000.0)
    except Exception as e:                                 # noqa: BLE001
        out["codecs"]["opus_celt_16stream_device"] = -1.0
        out.setdefault("errors", []).append(f"celt: {e}")

    try:
        from ohpipeline_jax.codecs.aac.serving import \
            decode_he_streams_device

        def he_s(i):
            def b():
                pcm = _content(secs, 44100, stereo=True)
                pcm = np.roll(pcm, 37 * i, axis=1)
                return _oracle_encode("aac_oracle", pcm,
                                      ["44100", "2", "48000", "2", "5"])
            return _cached(f"heaac16_{i}", b)
        streams = [he_s(i) for i in range(16)]
        decode_he_streams_device(streams)                     # warm
        out["codecs"]["he_aac_16stream_device"] = timed(
            lambda: decode_he_streams_device(streams),
            lambda o: sum(x.shape[1] for x in o) / 88200.0)
    except Exception as e:                                 # noqa: BLE001
        out["codecs"]["he_aac_16stream_device"] = -1.0
        out.setdefault("errors", []).append(f"he: {e}")

    try:
        from ohpipeline_jax.codecs.mp3.serving import \
            decode_mp3_streams_device

        def m3(i):
            def b():
                from ohpipeline_jax.codecs.mp3 import encoder as ENC
                rng = np.random.default_rng(300 + i)
                frames = []
                for _ in range(int(secs * 44100 / 1152)):
                    spec = np.zeros((2, 576), np.int32)
                    m = rng.random((2, 576)) < 0.25
                    spec[m] = rng.integers(1, 12, m.sum())
                    frames.append(ENC.build_frame(
                        [spec[0], spec[1]],
                        global_gain=int(rng.integers(174, 184))))
                return b"".join(frames)
            return b
        streams = [_cached(f"mp3_16_{i}", m3(i)) for i in range(16)]
        decode_mp3_streams_device(streams)                    # warm
        out["codecs"]["mp3_16stream_device"] = timed(
            lambda: decode_mp3_streams_device(streams),
            lambda o: sum(x.shape[1] for x in o) / 44100.0)
    except Exception as e:                                 # noqa: BLE001
        out["codecs"]["mp3_16stream_device"] = -1.0
        out.setdefault("errors", []).append(f"mp3: {e}")

    try:
        from ohpipeline_jax.codecs.vorbis import vorbis_jax

        def vb(i):
            def build():
                from ohpipeline_jax.codecs.vorbis.encoder import \
                    StreamSpec
                rng = np.random.default_rng(100 + i)
                spec = StreamSpec(channels=2, sample_rate=44100,
                                  bs0=256, bs1=1024, coupling=True)
                blocks = []
                for _ in range(int(secs * 44100 / 512)):
                    r = np.zeros((2, 512), np.int64)
                    m = rng.random((2, 512)) < 0.3
                    r[m] = rng.integers(-2, 3, m.sum())
                    blocks.append((1, [(140, 120)] * 2, r))
                return spec.build(blocks)
            return build
        streams = [_cached(f"vorbis16_{i}", vb(i)) for i in range(16)]
        vorbis_jax.decode_vorbis_streams_device(streams)      # warm
        out["codecs"]["vorbis_16stream_device"] = timed(
            lambda: vorbis_jax.decode_vorbis_streams_device(streams),
            lambda o: sum(x.shape[1] for x in o) / 44100.0)
    except Exception as e:                                 # noqa: BLE001
        out["codecs"]["vorbis_16stream_device"] = -1.0
        out.setdefault("errors", []).append(f"vorbis: {e}")

    vals = [v for v in out["codecs"].values() if v > 0]
    out["floor"] = round(min(vals), 2) if vals else 0.0
    return out


def all_codecs_bench(passes: int = 3) -> dict:
    """Beyond-parity headline: ONE pass decoding FLAC + AAC-LC +
    HE-AAC + MP3 + Vorbis + CELT stream mixes CONCURRENTLY on one chip
    — every serving entry point live at once, the whole-product number
    a per-codec renderer cannot state.  Each codec family's 16-stream
    (8 for FLAC/AAC-LC — they also carry the main bench) batch runs on
    its own thread; the device serializes execs, the threads keep the
    upload/parse/download phases of different codecs overlapped.

    Returns {"all_codecs_realtime_x": total_audio_s / wall, ...}."""
    import threading

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from oracles import ensure_oracles
    if not ensure_oracles():
        return {"error": "oracles unavailable"}
    secs = SECONDS
    from ohpipeline_jax.codecs import flac as FL
    from ohpipeline_jax.codecs.flac import serving as FS
    from ohpipeline_jax.codecs.aac import serving as AS
    from ohpipeline_jax.codecs.mp3.serving import decode_mp3_streams_device
    from ohpipeline_jax.codecs.opus import celt_jax
    from ohpipeline_jax.codecs.vorbis import vorbis_jax

    def flac_streams():
        out = []
        for i in range(8):
            def b(i=i):
                pcm = _content(secs, 44100, stereo=True)
                pcm = np.roll(pcm, 13 * i, axis=1)
                return FL.encode_flac(pcm, 44100, 16, blocksize=1024)
            out.append(_cached(f"allc_flac_{i}", b))
        return out

    def aac_streams():
        out = []
        for i in range(8):
            def b(i=i):
                pcm = _content(secs, 44100, stereo=True)
                pcm = np.roll(pcm, 17 * i, axis=1)
                return _oracle_encode("aac_oracle", pcm,
                                      ["44100", "2", "128000"])
            out.append(_cached(f"allc_aac_{i}", b))
        return out

    def he_streams():
        out = []
        for i in range(16):
            def b(i=i):
                pcm = _content(secs, 44100, stereo=True)
                pcm = np.roll(pcm, 37 * i, axis=1)
                return _oracle_encode("aac_oracle", pcm,
                                      ["44100", "2", "48000", "2", "5"])
            out.append(_cached(f"heaac16_{i}", b))
        return out

    def celt_streams():
        out = []
        for i in range(16):
            def b(i=i):
                pcm = _content(secs, 48000, stereo=True)
                pcm = np.roll(pcm, 31 * i, axis=1)
                return _oracle_encode("opus_oracle", pcm,
                                      ["2", "96000", "celt"])
            out.append(_cached(f"opus_celt16_{i}", b))
        return out

    def mp3_streams():
        from ohpipeline_jax.codecs.mp3 import encoder as ENC
        out = []
        for i in range(16):
            def b(i=i):
                rng = np.random.default_rng(300 + i)
                frames = []
                for _ in range(int(secs * 44100 / 1152)):
                    spec = np.zeros((2, 576), np.int32)
                    m = rng.random((2, 576)) < 0.25
                    spec[m] = rng.integers(1, 12, m.sum())
                    frames.append(ENC.build_frame(
                        [spec[0], spec[1]],
                        global_gain=int(rng.integers(174, 184))))
                return b"".join(frames)
            out.append(_cached(f"mp3_16_{i}", b))
        return out

    def vorbis_streams():
        from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
        out = []
        for i in range(16):
            def b(i=i):
                rng = np.random.default_rng(100 + i)
                spec = StreamSpec(channels=2, sample_rate=44100,
                                  bs0=256, bs1=1024, coupling=True)
                blocks = []
                for _ in range(int(secs * 44100 / 512)):
                    r = np.zeros((2, 512), np.int64)
                    m = rng.random((2, 512)) < 0.3
                    r[m] = rng.integers(-2, 3, m.sum())
                    blocks.append((1, [(140, 120)] * 2, r))
                return spec.build(blocks)
            out.append(_cached(f"vorbis16_{i}", b))
        return out

    jobs = [
        ("flac", flac_streams(), lambda s: FS.decode_flac_streams_device(
            s, frames_per_group=32),
         lambda o: sum(x.shape[1] for x in o) / 44100.0),
        ("aac_lc", aac_streams(), lambda s: AS.decode_aac_streams_device(
            s), lambda o: sum(x.shape[1] for x in o) / 44100.0),
        ("he_aac", he_streams(), lambda s: AS.decode_he_streams_device(
            s), lambda o: sum(x.shape[1] for x in o) / 88200.0),
        ("celt", celt_streams(),
         lambda s: celt_jax.decode_celt_streams_device(s),
         lambda o: o.shape[0] * o.shape[2] / 48000.0),
        ("mp3", mp3_streams(), decode_mp3_streams_device,
         lambda o: sum(x.shape[1] for x in o) / 44100.0),
        ("vorbis", vorbis_streams(),
         vorbis_jax.decode_vorbis_streams_device,
         lambda o: sum(x.shape[1] for x in o) / 44100.0),
    ]
    for name, streams, fn, _a in jobs:       # warm every program
        fn(streams)

    def one_pass():
        audio = {}
        errs = []

        def run(name, streams, fn, audio_of):
            try:
                audio[name] = audio_of(fn(streams))
            except Exception as e:               # noqa: BLE001
                errs.append(f"{name}: {e}")
        ths = [threading.Thread(target=run, args=j) for j in jobs]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        wall = time.perf_counter() - t0
        if errs:
            raise RuntimeError("; ".join(errs))
        return sum(audio.values()), wall, audio

    best = None
    for _ in range(max(1, passes)):
        total, wall, audio = one_pass()
        x = total / wall
        if best is None or x > best["all_codecs_realtime_x"]:
            best = {"all_codecs_realtime_x": round(x, 1),
                    "audio_s_total": round(total, 1),
                    "wall_s": round(wall, 2),
                    "per_codec_audio_s": {k: round(v, 1)
                                          for k, v in audio.items()}}
    return best


def main() -> int:
    # self-contained: build missing conformance oracles on first run
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from oracles import ensure_oracles
    if not ensure_oracles():
        print(json.dumps({"metric": "secondary_codecs_realtime_x",
                          "codecs": {}, "floor": 0.0,
                          "all_above_realtime": False,
                          "error": "oracles unavailable"}))
        return 1
    results: dict[str, float] = {}
    secs = SECONDS

    # --- Opus: SILK-WB speech (mono + stereo) and CELT music ----------
    def opus_build(mode_args):
        def b():
            ch = int(mode_args[0])
            pcm = _content(secs, 48000, stereo=(ch == 2))
            return _oracle_encode("opus_oracle", pcm,
                                  list(mode_args))
        return b

    from ohpipeline_jax.codecs.opus import decode_opus
    data = _cached("opus_silk_wb", opus_build(("1", "24000", "silk")))
    results["opus_silk_wb"] = bench_one(
        "opus_silk_wb", data, decode_opus, secs)
    data = _cached("opus_silk_st", opus_build(("2", "48000", "silk")))
    results["opus_silk_stereo"] = bench_one(
        "opus_silk_stereo", data, decode_opus, secs)
    data = _cached("opus_celt", opus_build(("2", "96000", "celt")))
    results["opus_celt_stereo"] = bench_one(
        "opus_celt_stereo", data, decode_opus, secs)
    data = _cached("opus_hybrid", opus_build(("1", "32000", "hybrid")))
    results["opus_hybrid"] = bench_one(
        "opus_hybrid", data, decode_opus, secs)

    # --- Opus CELT multi-stream device synthesis (the serving shape:
    # entropy on host, denorm/IMDCT/comb/deemph batched on the chip —
    # codecs/opus/celt_jax.py) -----------------------------------------
    try:
        from ohpipeline_jax.codecs.opus import celt_jax
        celt_streams = []
        for i in range(16):
            def b(i=i):
                pcm = _content(secs, 48000, stereo=True)
                pcm = np.roll(pcm, 31 * i, axis=1)     # distinct streams
                return _oracle_encode("opus_oracle", pcm,
                                      ["2", "96000", "celt"])
            celt_streams.append(_cached(f"opus_celt16_{i}", b))
        celt_jax.decode_celt_streams_device(celt_streams)   # warm jit
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            out = celt_jax.decode_celt_streams_device(celt_streams)
            best = min(best, time.perf_counter() - t0)
        results["opus_celt_16stream_device"] = \
            out.shape[0] * out.shape[2] / 48000.0 / best
    except Exception as e:                             # noqa: BLE001
        results["opus_celt_16stream_device"] = -1.0
        print(f"# celt device bench failed: {e}", file=sys.stderr)

    # --- HE-AAC v1 (device SBR group path) ---------------------------
    def he_build():
        pcm = _content(secs, 44100, stereo=True)
        return _oracle_encode("aac_oracle", pcm,
                              ["44100", "2", "48000", "2", "5"])

    from ohpipeline_jax.codecs.aac import CodecAacAdts
    from ohpipeline_jax.codecs.base import EndOfStream

    class _Rdr:
        def __init__(self, b):
            self._b, self._p = b, 0
            self.stream_bytes = len(b)

        def read(self, n):
            out = self._b[self._p:self._p + n]
            self._p += len(out)
            return out

        def peek(self, n):
            return self._b[self._p:self._p + n]

    def decode_he(data):
        c = CodecAacAdts()
        r = _Rdr(data)
        assert c.recognise(r.peek(8192))
        c.stream_initialise(r)
        try:
            while True:
                c.process(r).resolve()
        except EndOfStream:
            pass

    data = _cached("heaac_v1", he_build)
    decode_he(data)                        # warm jit before timing
    results["he_aac_v1_device_sbr"] = bench_one(
        "he_aac_v1", data, decode_he, secs)

    # --- HE-AAC 16-stream device serving (one SBR dispatch/group) ----
    try:
        from ohpipeline_jax.codecs.aac.serving import \
            decode_he_streams_device

        def he_s(i):
            def b():
                pcm = _content(secs, 44100, stereo=True)
                pcm = np.roll(pcm, 37 * i, axis=1)   # distinct streams
                return _oracle_encode("aac_oracle", pcm,
                                      ["44100", "2", "48000", "2", "5"])
            return _cached(f"heaac16_{i}", b)

        he_streams = [he_s(i) for i in range(16)]
        decode_he_streams_device(he_streams)           # warm jit
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            out = decode_he_streams_device(he_streams)
            best = min(best, time.perf_counter() - t0)
        results["he_aac_16stream_device"] = \
            sum(o.shape[1] for o in out) / 88200.0 / best
    except Exception as e:                             # noqa: BLE001
        results["he_aac_16stream_device"] = -1.0
        print(f"# he-aac device bench failed: {e}", file=sys.stderr)

    # --- MP3 (own frame builder content, libmad-validated decode) ----
    def mp3_build():
        from ohpipeline_jax.codecs.mp3 import encoder as ENC
        rng = np.random.default_rng(3)
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.25
        spec[m] = rng.integers(1, 12, m.sum())
        nfr = int(secs * 44100 / 1152)
        return ENC.build_stream([spec[0], spec[1]], nframes=nfr)

    from ohpipeline_jax.codecs.mp3 import decode_mp3
    try:
        data = _cached("mp3", mp3_build)
        info, pcm = decode_mp3(data)
        msecs = pcm.shape[1] / 44100.0
        results["mp3"] = bench_one("mp3", data, decode_mp3, msecs)
    except Exception as e:                             # noqa: BLE001
        results["mp3"] = -1.0
        print(f"# mp3 bench failed: {e}", file=sys.stderr)

    # --- MP3 16-stream device serving (one filterbank dispatch/group,
    # int16 spectrum wire — codecs/mp3/serving.py) ---------------------
    try:
        from ohpipeline_jax.codecs.mp3.serving import \
            decode_mp3_streams_device

        def m3(i):
            def b():
                from ohpipeline_jax.codecs.mp3 import encoder as ENC
                rng = np.random.default_rng(300 + i)
                frames = []
                for _ in range(int(secs * 44100 / 1152)):
                    spec = np.zeros((2, 576), np.int32)
                    m = rng.random((2, 576)) < 0.25
                    spec[m] = rng.integers(1, 12, m.sum())
                    frames.append(ENC.build_frame(
                        [spec[0], spec[1]],
                        global_gain=int(rng.integers(174, 184))))
                return b"".join(frames)
            return b
        m_streams = [_cached(f"mp3_16_{i}", m3(i)) for i in range(16)]
        decode_mp3_streams_device(m_streams)               # warm jit
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            outs = decode_mp3_streams_device(m_streams)
            best = min(best, time.perf_counter() - t0)
        results["mp3_16stream_device"] = \
            sum(o.shape[1] for o in outs) / 44100.0 / best
    except Exception as e:                             # noqa: BLE001
        results["mp3_16stream_device"] = -1.0
        print(f"# mp3 device bench failed: {e}", file=sys.stderr)

    # --- Vorbis (own spec-valid stream builder, as the conformance
    # tests use; residual density comparable to music at ~q4) ---------
    def vorbis_build():
        from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
        rng = np.random.default_rng(7)
        spec = StreamSpec(channels=2, sample_rate=44100, bs0=256,
                          bs1=1024, coupling=True)
        nblocks = int(secs * 44100 / 512)      # long blocks, 1024/2 new
        blocks = []
        for _ in range(nblocks):
            half = 512
            r = np.zeros((2, half), np.int64)
            m = rng.random((2, half)) < 0.3
            r[m] = rng.integers(-2, 3, m.sum())
            blocks.append((1, [(140, 120)] * 2, r))
        return spec.build(blocks)

    from ohpipeline_jax.codecs.vorbis import decode_vorbis
    try:
        data = _cached("vorbis", vorbis_build)
        info, pcm = decode_vorbis(data)
        vsecs = pcm.shape[1] / 44100.0
        results["vorbis"] = bench_one("vorbis", data, decode_vorbis,
                                      vsecs)
    except Exception as e:                             # noqa: BLE001
        results["vorbis"] = -1.0
        print(f"# vorbis bench failed: {e}", file=sys.stderr)

    # --- Vorbis multi-stream device synthesis (the serving shape:
    # entropy on host, IMDCT/window/overlap-add batched on the chip —
    # codecs/vorbis/vorbis_jax.py) -------------------------------------
    try:
        from ohpipeline_jax.codecs.vorbis import vorbis_jax

        def vb(i):
            def build():
                from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
                rng = np.random.default_rng(100 + i)
                spec = StreamSpec(channels=2, sample_rate=44100, bs0=256,
                                  bs1=1024, coupling=True)
                blocks = []
                for _ in range(int(secs * 44100 / 512)):
                    r = np.zeros((2, 512), np.int64)
                    m = rng.random((2, 512)) < 0.3
                    r[m] = rng.integers(-2, 3, m.sum())
                    blocks.append((1, [(140, 120)] * 2, r))
                return spec.build(blocks)
            return build
        v_streams = [_cached(f"vorbis16_{i}", vb(i)) for i in range(16)]
        vorbis_jax.decode_vorbis_streams_device(v_streams)      # warm jit
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            outs = vorbis_jax.decode_vorbis_streams_device(v_streams)
            best = min(best, time.perf_counter() - t0)
        results["vorbis_16stream_device"] = \
            sum(o.shape[1] for o in outs) / 44100.0 / best
    except Exception as e:                             # noqa: BLE001
        results["vorbis_16stream_device"] = -1.0
        print(f"# vorbis device bench failed: {e}", file=sys.stderr)

    # --- ALAC (oracle cookie+packet container -> decode_packet) ------
    def alac_build():
        pcm = _content(secs, 44100, stereo=True)
        return _oracle_encode("alac_oracle", pcm, ["44100", "2"])

    try:
        import struct
        from ohpipeline_jax.codecs import alac as AL
        data = _cached("alac", alac_build)

        def decode_alac_all(raw):
            clen = struct.unpack("<I", raw[:4])[0]
            cookie = raw[4:4 + clen]
            p = 4 + clen
            npk = struct.unpack("<I", raw[p:p + 4])[0]
            p += 4
            cfg = AL.AlacConfig.parse(cookie)
            for _ in range(npk):
                sz = struct.unpack("<I", raw[p:p + 4])[0]
                p += 4
                AL.decode_packet(raw[p:p + sz], cfg)
                p += sz

        results["alac"] = bench_one("alac", data, decode_alac_all, secs)
    except Exception as e:                             # noqa: BLE001
        results["alac"] = -1.0
        print(f"# alac bench failed: {e}", file=sys.stderr)

    vals = [v for v in results.values() if v > 0]
    line = {"metric": "secondary_codecs_realtime_x",
            "codecs": {k: round(v, 2) for k, v in results.items()},
            "floor": round(min(vals), 2) if vals else 0.0,
            "all_above_realtime": bool(vals) and min(vals) >= 1.0}
    with open(os.path.join(HERE, "BENCH_SECONDARY.json"), "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
