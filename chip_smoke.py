#!/usr/bin/env python3
"""Smoke run of the served decode and render path on an NVIDIA GPU.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --multichip   # four GPUs: the mesh path only

One process drives the card.  Each phase goes through the entry point a
user calls and compares its output with the repository's plain
reference, printing the tolerance it holds:

1. headline shape: decode_flac_streams_device on 16 distinct 30 s
   44.1 kHz stereo FLAC streams (bit-exact vs the source PCM and the
   codec path), decode_aac_streams_device on 48 AAC-LC streams of about
   30 s (vs the CodecAac decode: <= 2 LSB, and the energy of the noise
   substituted frames within 0.2 dB);
2. the other serving calls, 16 streams each: HE-AAC (vs the numpy SBR
   chain), MP3, Vorbis and CELT (vs their host decodes);
3. the LPC kernel alone at the FLAC serving shape, bit-exact vs the
   lax.scan reference, and the tests marked `gpu`;
4. the renderer: PipelineManager.play_uri on a FLAC file through
   AnimatorBatch (equal to the source PCM at unity gain), then
   __graft_entry__.entry() vs its scan reference;
5. device memory of the largest program and the peak in use.

Content comes from the repository's encoders and tests/assets, made
from fixed seeds and cached in .bench_cache/.  Times printed here are
smoke timings of one run, labelled with the card's name and power
limit; they are not benchmark results.  The script exits non-zero
without a result line when JAX finds no GPU, and when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache", "smoke")
ASSETS = os.path.join(ROOT, "tests", "assets")
RATE = 44100


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Report:
    """Runs phases, prints each outcome, remembers failures."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def time(self, what: str, seconds: float) -> None:
        print(f"  [smoke timing, not a benchmark; {self.card}] {what}: "
              f"{seconds:.3f} s", flush=True)

    @contextlib.contextmanager
    def phase(self, name: str):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception:                         # noqa: BLE001
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)
        else:
            print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


def _timed(fn, *a, **k):
    t0 = time.perf_counter()
    out = fn(*a, **k)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# content, from fixed seeds
# ---------------------------------------------------------------------------

def _cached(name: str, make) -> bytes:
    path = os.path.join(CACHE, name)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    data = make()
    os.makedirs(CACHE, exist_ok=True)
    with open(path + f".{os.getpid()}", "wb") as f:
        f.write(data)
    os.replace(path + f".{os.getpid()}", path)
    return data


def flac_pcm(seed: int, seconds: float) -> np.ndarray:
    """Stereo 16-bit music-like content: three partials, a slow
    amplitude swell and noise, with a correlated second channel."""
    rng = np.random.default_rng(seed)
    n = int(RATE * seconds)
    t = np.arange(n) / RATE
    x = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in zip(
        rng.uniform(2000, 6000, 3), rng.uniform(80, 4000, 3),
        rng.uniform(0, 6.3, 3)))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t))
    y = 0.7 * np.roll(x, 17) + rng.standard_normal(n) * 300
    x = x + rng.standard_normal(n) * 300
    return np.clip(np.rint(np.stack([x, y])), -32768, 32767) \
        .astype(np.int32)


def flac_streams(n_streams: int, seconds: float, seed: int = 1):
    """[(pcm, FLAC bytes)] from the repository's FLAC encoder."""
    from ohpipeline_jax.codecs import flac
    out = []
    for s in range(n_streams):
        pcm = flac_pcm(seed * 1000 + s, seconds)
        blob = _cached(f"flac_{seed}_{s}_{seconds:g}s.flac",
                       lambda: flac.encode_flac(pcm, RATE, 16))
        out.append((pcm, blob))
    return out


def adts_frames(asset: str) -> list[bytes]:
    from ohpipeline_jax.codecs.aac import bitstream as BS
    with open(os.path.join(ASSETS, asset), "rb") as f:
        data = f.read()
    frames, pos = [], 0
    while True:
        h = BS.parse_adts_header(data, pos)
        if h is None or pos + h.frame_bytes > len(data):
            return frames
        frames.append(data[pos:pos + h.frame_bytes])
        pos += h.frame_bytes


def pns_frames(frames: list[bytes]) -> set[int]:
    """Indices of the ADTS frames that carry perceptual noise
    substitution: a band of some channel coded with the noise codebook."""
    from ohpipeline_jax.codecs.aac import bitstream as BS
    from ohpipeline_jax.codecs.flac.bitreader import BitReader
    out = set()
    for i, f in enumerate(frames):
        h = BS.parse_adts_header(f)
        fr = BS.parse_raw_data_block(BitReader(f, h.header_bytes * 8),
                                     h.rate_index)
        if any((ch.band_cb == NOISE_HCB).any() for ch in fr.channels):
            out.add(i)
    return out


def rotated_streams(frames: list, n_streams: int, n_frames: int,
                    step: int) -> list[list]:
    """Stream s: the frames from index s*step on, looped to n_frames,
    so every stream carries different content at every instant."""
    out = []
    for s in range(n_streams):
        r = (s * step) % len(frames)
        seq = frames[r:] + frames[:r]
        out.append([seq[i % len(seq)] for i in range(n_frames)])
    return out


def he_streams(n_streams: int, n_frames: int) -> list[bytes]:
    """HE-AAC v1 streams from tests/assets/dryrun_he.aac.  Its SBR
    header repeats every 10 frames, and a stream must open with one, so
    each stream strings the asset's header-led runs of frames together
    in its own seeded order."""
    frames = adts_frames("dryrun_he.aac")
    runs = [frames[i:i + 10] for i in range(0, len(frames), 10)]
    out = []
    for s in range(n_streams):
        rng = np.random.default_rng(900 + s)
        seq: list = []
        while len(seq) < n_frames:
            seq += runs[int(rng.integers(len(runs)))]
        out.append(b"".join(seq[:n_frames]))
    return out


def mp3_stream(seed: int, nframes: int) -> bytes:
    """Stereo MP3 from the repository's encoder: random sparse spectra
    and gains per frame."""
    from ohpipeline_jax.codecs.mp3 import encoder as ENC
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(nframes):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.22
        spec[m] = rng.integers(1, 12, m.sum())
        spec[rng.random((2, 576)) < 0.5] *= -1
        frames.append(ENC.build_frame([spec[0], spec[1]],
                                      global_gain=int(rng.integers(172, 186))))
    return b"".join(frames)


def vorbis_stream(seed: int, nblocks: int) -> bytes:
    """Stereo coupled Vorbis from the repository's encoder, with a
    mixed long/short window sequence."""
    from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
    rng = np.random.default_rng(seed)
    spec = StreamSpec(channels=2, sample_rate=RATE, bs0=256, bs1=1024,
                      coupling=True)
    blocks = []
    for _ in range(nblocks):
        lng = int(rng.random() < 0.7)
        half = 512 if lng else 128
        r = np.zeros((2, half), np.int64)
        m = rng.random((2, half)) < 0.3
        r[m] = rng.integers(-2, 3, m.sum())
        fy = [(int(rng.integers(100, 200)), int(rng.integers(80, 200)))
              for _ in range(2)]
        blocks.append((lng, fy, r))
    return spec.build(blocks)


def opus_streams(n_streams: int, n_packets: int) -> list[bytes]:
    """CELT-only Ogg Opus streams from tests/assets/dryrun.opus: the
    audio packets rotated per stream and looped to n_packets."""
    from ohpipeline_jax.codecs.base import BufferReader
    from ohpipeline_jax.containers.ogg import OggReader, build_pages
    with open(os.path.join(ASSETS, "dryrun.opus"), "rb") as f:
        packets = list(OggReader(BufferReader(f.read())).packets())
    head, tags, audio = packets[0], packets[1], packets[2:]
    out = []
    for s, seq in enumerate(rotated_streams(audio, n_streams, n_packets,
                                            5)):
        out.append(build_pages(s + 1, [head], bos=True)
                   + build_pages(s + 1, [tags], first_sequence=1)
                   + build_pages(s + 1, seq, first_sequence=2, eos=True))
    return out


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def he_numpy_reference(data: bytes) -> np.ndarray:
    """HE-AAC v1 through the per-frame numpy SBR chain (codecs/aac/
    sbr.py), float output at the doubled rate."""
    from ohpipeline_jax.codecs.aac import (_StreamState,
                                           decode_frames_float)
    from ohpipeline_jax.codecs.aac import bitstream as BS
    from ohpipeline_jax.codecs.aac.sbr import SbrDecoder
    from ohpipeline_jax.codecs.flac.bitreader import BitReader
    pos, dec, state, outs = 0, None, None, []
    while True:
        h = BS.parse_adts_header(data, pos)
        if h is None or pos + h.frame_bytes > len(data):
            break
        if dec is None:
            dec, state = SbrDecoder(h.sample_rate), _StreamState(h.channels)
        br = BitReader(data, (pos + h.header_bytes) * 8)
        fr = BS.parse_raw_data_block(br, h.rate_index)
        pos += h.frame_bytes
        core = decode_frames_float([fr], state)
        payload, nbits, crc = fr.sbr
        chans, coupling = dec.parse_payload(payload, nbits,
                                            stereo=h.channels == 2,
                                            crc=crc)
        outs.append(dec.process_frame(core, chans, coupling))
    return np.concatenate(outs, axis=1)


def celt_host_reference(data: bytes) -> np.ndarray:
    """CELT-only Ogg Opus through the host CELT decoder, int16-rounded
    like the device output (no pre-skip trimming)."""
    from ohpipeline_jax.codecs.base import BufferReader
    from ohpipeline_jax.codecs.opus import split_packet_frames
    from ohpipeline_jax.codecs.opus.celt import (CeltDecoderState,
                                                 decode_frame)
    from ohpipeline_jax.containers.ogg import OggReader
    packets = list(OggReader(BufferReader(data)).packets())[2:]
    st, outs = None, []
    for pk in packets:
        toc, frames = split_packet_frames(pk)
        if st is None:
            st = CeltDecoderState(2 if toc.stereo else 1)
        outs += [decode_frame(st, f, 960) for f in frames]
    pcm = np.concatenate(outs, axis=1) * 32768.0
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)


def _max_abs(a, b) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _snr_db(ref, x) -> float:
    err = ref.astype(np.float64) - x.astype(np.float64)
    p = float((ref.astype(np.float64) ** 2).sum())
    return 10 * np.log10(p / max(float((err ** 2).sum()), 1e-30))


# ---------------------------------------------------------------------------
# phases (each callable alone, at any size, on any backend)
# ---------------------------------------------------------------------------

#: name -> (jitted program, argument shapes, static kwargs) of the
#: serving programs the phases ran, for the memory phase
_PROGRAMS: dict = {}


def phase_flac(rep: Report, n_streams=16, seconds=30.0, frames_per_group=32):
    import jax

    from ohpipeline_jax.codecs import flac
    from ohpipeline_jax.codecs.flac.serving import decode_flac_streams_device
    content = flac_streams(n_streams, seconds)
    streams = [b for _, b in content]
    real = flac.synthesise_group_rice_jit

    def spy(*a, **k):          # keeps the program's argument shapes
        _PROGRAMS["flac"] = (real, jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), a), k)
        return real(*a, **k)

    flac.synthesise_group_rice_jit = spy
    try:
        outs, t = _timed(decode_flac_streams_device, streams,
                         frames_per_group=frames_per_group)
    finally:
        flac.synthesise_group_rice_jit = real
    rep.time(f"decode_flac_streams_device {n_streams} x {seconds:g} s, "
             f"first call (compile included)", t)
    outs, t = _timed(decode_flac_streams_device, streams,
                     frames_per_group=frames_per_group)
    rep.time(f"decode_flac_streams_device {n_streams} x {seconds:g} s, "
             f"second call", t)
    for s, ((pcm, blob), got) in enumerate(zip(content, outs)):
        np.testing.assert_array_equal(got, pcm, err_msg=f"stream {s}")
        _, host = flac.decode_flac(blob)
        np.testing.assert_array_equal(got, host, err_msg=f"stream {s}")
    print(f"  FLAC: {n_streams} streams x {outs[0].shape[1]} samples, "
          f"bit-exact (tolerance 0) vs source PCM and flac.decode_flac")


#: the AAC codebook that marks a noise-substituted band
NOISE_HCB = 13
#: the serving path and CodecAac fill noise-substituted bands from
#: different generators, both scaled to the energy the stream codes, so
#: on the output blocks such a frame reaches (its own and the next) only
#: each channel's energy is compared: within this bound, in dB (the CPU
#: backend measures 0.02-0.08 dB on single blocks of this content)
PNS_ENERGY_DB = 0.2


def phase_aac(rep: Report, n_streams=48, seconds=30.0, frames_per_group=64):
    from ohpipeline_jax.codecs.aac import decode_adts
    from ohpipeline_jax.codecs.aac.serving import decode_aac_streams_device
    n_frames = int(round(seconds * RATE / 1024))
    frames = adts_frames("dryrun.aac")
    pns = pns_frames(frames)
    seqs = rotated_streams(list(range(len(frames))), n_streams, n_frames,
                           11)
    streams = [b"".join(frames[i] for i in q) for q in seqs]
    outs, t = _timed(decode_aac_streams_device, streams,
                     frames_per_group=frames_per_group)
    rep.time(f"decode_aac_streams_device {n_streams} x {seconds:g} s, "
             f"first call (compile included)", t)
    worst, worst_db, n_pns = 0, 0.0, 0
    for s, (q, data, got) in enumerate(zip(seqs, streams, outs)):
        ref = decode_adts(data)[1]
        n = min(got.shape[1], ref.shape[1])
        assert abs(got.shape[1] - ref.shape[1]) <= 2 * 1024, s
        assert n >= (n_frames - 2) * 1024, (s, n)
        noisy_block = np.zeros(len(q) + 2, bool)
        for p, i in enumerate(q):
            if i in pns:
                noisy_block[p:p + 2] = True
        noisy = noisy_block[np.arange(n) // 1024]
        g, r = got[:, :n], ref[:, :n]
        worst = max(worst, _max_abs(g[:, ~noisy], r[:, ~noisy]))
        if noisy.any():
            n_pns += int(noisy_block.sum())
            eg = (g[:, noisy].astype(np.float64) ** 2).sum(axis=1)
            er = (r[:, noisy].astype(np.float64) ** 2).sum(axis=1)
            worst_db = max(worst_db,
                           float(np.abs(10 * np.log10(eg / er)).max()))
    assert n_pns, "no stream carries a noise-substituted frame"
    assert worst <= 2 and worst_db <= PNS_ENERGY_DB, (worst, worst_db)
    print(f"  AAC-LC: {n_streams} streams x {n_frames} frames, max "
          f"|device - CodecAac| = {worst} LSB (tolerance 2 LSB); on the "
          f"{n_pns} blocks with noise substitution, channel energy within "
          f"{worst_db:.4f} dB (tolerance {PNS_ENERGY_DB} dB)")


#: HE-AAC device output vs the numpy SBR chain, in int16 LSB.  The CPU
#: backend measures 0.58 LSB on this content (the device output is
#: rounded, the reference is float); the bound leaves a margin of 3.4x
#: for the card's other summation order in the float32 QMF products
HE_BOUND_LSB = 2.0


def phase_he(rep: Report, n_streams=16, seconds=5.0, frames_per_group=48):
    from ohpipeline_jax.codecs.aac.serving import decode_he_streams_device
    n_frames = int(round(seconds * RATE / 2048))
    streams = he_streams(n_streams, n_frames)
    outs, t = _timed(decode_he_streams_device, streams,
                     frames_per_group=frames_per_group)
    rep.time(f"decode_he_streams_device {n_streams} x {seconds:g} s, "
             f"first call (compile included)", t)
    worst = 0.0
    for s, (data, got) in enumerate(zip(streams, outs)):
        ref = he_numpy_reference(data)
        n = min(got.shape[1], ref.shape[1])
        assert n >= (n_frames - 2) * 2048, (s, n)
        worst = max(worst, float(np.abs(got[:, :n] - ref[:, :n]).max()))
    print(f"  HE-AAC: {n_streams} streams x {n_frames} frames, max "
          f"|device - numpy SBR chain| = {worst:.3f} LSB (tolerance "
          f"{HE_BOUND_LSB} LSB)")
    assert worst <= HE_BOUND_LSB, worst


def phase_mp3(rep: Report, n_streams=16, nframes=400, frames_per_group=32):
    from ohpipeline_jax.codecs.mp3 import decode_mp3
    from ohpipeline_jax.codecs.mp3.serving import decode_mp3_streams_device
    streams = [mp3_stream(700 + s, nframes) for s in range(n_streams)]
    outs, t = _timed(decode_mp3_streams_device, streams,
                     frames_per_group=frames_per_group)
    rep.time(f"decode_mp3_streams_device {n_streams} x {nframes} frames, "
             f"first call (compile included)", t)
    worst, snr = 0, np.inf
    for s, (data, got) in enumerate(zip(streams, outs)):
        ref = decode_mp3(data)[1]
        assert got.shape == ref.shape, (s, got.shape, ref.shape)
        worst = max(worst, _max_abs(got, ref))
        snr = min(snr, _snr_db(ref, got))
    # the bound of tests/test_mp3_serving.py; this content reaches its
    # 6 LSB on the CPU and on the card alike
    assert worst <= 6 and snr >= 80.0, (worst, snr)
    print(f"  MP3: {n_streams} streams x {nframes} frames, max |device - "
          f"decode_mp3| = {worst} LSB, min SNR {snr:.1f} dB (tolerance "
          f"6 LSB, 80 dB)")


def phase_vorbis(rep: Report, n_streams=16, nblocks=400, group=64):
    from ohpipeline_jax.codecs.vorbis import decode_vorbis
    from ohpipeline_jax.codecs.vorbis.vorbis_jax import (
        decode_vorbis_streams_device)
    streams = [vorbis_stream(300 + s, nblocks) for s in range(n_streams)]
    outs, t = _timed(decode_vorbis_streams_device, streams, group=group)
    rep.time(f"decode_vorbis_streams_device {n_streams} x {nblocks} "
             f"blocks, first call (compile included)", t)
    worst = 0
    for s, (data, got) in enumerate(zip(streams, outs)):
        ref = decode_vorbis(data)[1]
        n = min(got.shape[1], ref.shape[1])
        assert n > 0 and abs(got.shape[1] - ref.shape[1]) <= 1024, s
        worst = max(worst, _max_abs(got[:, :n], ref[:, :n]))
    assert worst <= 1, worst
    print(f"  Vorbis: {n_streams} streams x {nblocks} blocks, max |device "
          f"- decode_vorbis| = {worst} LSB (tolerance 1 LSB)")


def phase_celt(rep: Report, n_streams=16, n_packets=250, group=32):
    from ohpipeline_jax.codecs.opus.celt_jax import decode_celt_streams_device
    streams = opus_streams(n_streams, n_packets)
    out, t = _timed(decode_celt_streams_device, streams, group=group)
    rep.time(f"decode_celt_streams_device {n_streams} x {n_packets} "
             f"packets, first call (compile included)", t)
    worst = 0
    for s, data in enumerate(streams):
        ref = celt_host_reference(data)
        n = out.shape[2]
        assert ref.shape[1] >= n >= n_packets * 960 // 2, (s, n)
        worst = max(worst, _max_abs(out[s], ref[:, :n]))
    assert worst <= 2, worst
    print(f"  CELT: {n_streams} streams x {out.shape[2]} samples, max "
          f"|device - host CELT| = {worst} LSB (tolerance 2 LSB, the "
          f"bound of tests/test_opus_celt_device.py)")


def lpc_serving_case(rows: int, n: int, seed: int = 5):
    """LPC inputs at the FLAC serving shape: orders 0-32, 15-bit
    coefficients, shifts 0-15, and residuals small enough that the
    24-bit samples stay in range for every row."""
    rng = np.random.default_rng(seed)
    order = rng.integers(0, 33, rows).astype(np.int32)
    order[: rows // 8] = rng.integers(0, 5, rows // 8)   # fixed-like
    shift = rng.integers(0, 16, rows).astype(np.int32)
    coeffs = np.zeros((rows, 32), np.int32)
    # a stable predictor: one leading tap, the rest small
    for b in range(rows):
        o = order[b]
        if o:
            c = rng.integers(-(1 << 10), 1 << 10, o)
            c[0] = (1 << shift[b]) // 2
            coeffs[b, :o] = c >> max(0, 10 - shift[b])
    data = rng.integers(-(1 << 12), 1 << 12, (rows, n)).astype(np.int32)
    data[:, :32] = rng.integers(-(1 << 23), 1 << 23, (rows, 32))
    return data, coeffs, shift, order


def phase_lpc(rep: Report, rows=1024, n=4096, gpu_tests=True):
    import jax
    import jax.numpy as jnp
    from ohpipeline_jax.ops import lpc
    interpret = jax.default_backend() != "gpu"
    args = [jnp.asarray(a) for a in lpc_serving_case(rows, n)]
    if interpret:
        kern = lambda *a: lpc.lpc_synthesize_pallas(*a, interpret=True)  # noqa: E731
    else:
        assert lpc.kernel_for("gpu") is lpc.lpc_synthesize_pallas
        kern = lpc.lpc_synthesize
    ref = np.asarray(lpc.lpc_synthesize_scan(*args))
    got = np.asarray(kern(*args))
    np.testing.assert_array_equal(got, ref)
    for name, fn in (("kernel", kern), ("lax.scan", lpc.lpc_synthesize_scan)):
        fn(*args).block_until_ready()
        _, t = _timed(lambda: fn(*args).block_until_ready())
        rep.time(f"LPC {name} alone at ({rows}, {n})", t)
    print(f"  LPC: ({rows}, {n}) {'interpret-mode ' if interpret else ''}"
          f"kernel bit-exact (tolerance 0) vs lpc_synthesize_scan")
    if gpu_tests:
        import pytest
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_lpc.py")])
        assert rc == 0, f"tests marked gpu: pytest exit code {rc}"


@contextlib.contextmanager
def lpc_scan_everywhere():
    """While the block runs, ops.lpc.lpc_synthesize traces the lax.scan
    reference on every backend: a scan twin of any program that is
    first called inside it."""
    from ohpipeline_jax.ops import lpc
    real = lpc.kernel_for
    lpc.kernel_for = lambda platform: lpc.lpc_synthesize_scan
    try:
        yield
    finally:
        lpc.kernel_for = real


def phase_renderer(rep: Report, seconds=20.0, nframes=64, n=4096):
    import jax

    import __graft_entry__
    from ohpipeline_jax import parallel
    from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pcm, blob = flac_streams(1, seconds, seed=7)[0]
    path = os.path.join(CACHE, f"render_{seconds:g}s.flac")
    with open(path, "wb") as f:
        f.write(blob)
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    mgr = PipelineManager(params)
    chunks, infos = [], []

    def sink(samples, info):
        chunks.append(samples)
        infos.append(info)

    t0 = time.perf_counter()
    try:
        mgr.play_uri(f"file://{path}")
        AnimatorBatch(mgr.pipeline.predriver, sink, use_device=True).run()
    finally:
        mgr.quit()
    rep.time(f"PipelineManager.play_uri, {seconds:g} s FLAC through "
             f"AnimatorBatch", time.perf_counter() - t0)
    out = np.concatenate(chunks, axis=1)
    assert infos[0].codec_name == "FLAC"
    np.testing.assert_array_equal(out, pcm)
    print(f"  renderer: {out.shape[1]} samples equal the source PCM at "
          f"unity gain (tolerance 0)")

    fn, args = __graft_entry__.entry(nframes=nframes, n=n)
    got = jax.block_until_ready(fn(*args))
    with lpc_scan_everywhere():
        ref = jax.jit(lambda *a: parallel.decode_render_step(
            *a, num_channels=2))(*args)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    print(f"  entry(nframes={nframes}, n={n}): rendered {got[0].shape} "
          f"and peaks equal the scan reference (tolerance 0)")


def phase_memory(rep: Report):
    """compiled.memory_analysis() of the FLAC serving program at the
    shape phase_flac ran (its (1024, 4096) int32 planes make it the
    largest program of the run) and the device's peak bytes in use."""
    import jax
    fn, shapes, kwargs = _PROGRAMS["flac"]
    mem = fn.lower(*shapes, **kwargs).compile().memory_analysis()
    print(f"  FLAC serving program memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


#: every phase of run_single with its arguments; the defaults are the
#: sizes the script runs on the card
PHASES = (
    ("1a FLAC headline (16 x 30 s)", phase_flac, {}),
    ("1b AAC-LC headline (48 x 30 s)", phase_aac, {}),
    ("2a HE-AAC serving (16 streams)", phase_he, {}),
    ("2b MP3 serving (16 streams)", phase_mp3, {}),
    ("2c Vorbis serving (16 streams)", phase_vorbis, {}),
    ("2d CELT serving (16 streams)", phase_celt, {}),
    ("3 LPC kernel alone + tests marked gpu", phase_lpc, {}),
    ("4 renderer + entry()", phase_renderer, {}),
    ("5 memory", phase_memory, {}),
)


def run_single(rep: Report, sizes: dict | None = None) -> None:
    """Every single-device phase; `sizes` maps a phase function's name
    to keyword arguments that replace its defaults."""
    from ohpipeline_jax import native
    with rep.phase("natives"):
        missing = [n for n in ("flac_unpack", "aac_unpack", "sbr_parse",
                               "mp3_core", "celt_core", "vorbis_core")
                   if not getattr(native, f"have_{n}")()]
        assert not missing, f"native libraries failed to build: {missing}"
    for name, fn, kw in PHASES:
        with rep.phase(name):
            fn(rep, **{**kw, **(sizes or {}).get(fn.__name__, {})})


def run_multichip(rep: Report, n_devices=4, n_streams=8, seconds=10.0):
    """The multi-device path alone: dryrun_multichip on real devices,
    then each serving call with mesh= over every device vs mesh=None."""
    import jax

    import __graft_entry__
    from ohpipeline_jax import parallel
    from ohpipeline_jax.codecs.aac import serving as AS
    from ohpipeline_jax.codecs.flac.serving import decode_flac_streams_device
    from ohpipeline_jax.codecs.mp3.serving import decode_mp3_streams_device
    n_found = len(jax.devices())
    assert n_found >= n_devices, f"needs {n_devices} devices, found {n_found}"
    mesh = parallel.make_mesh(n_devices)
    with rep.phase(f"make_mesh({n_devices}) shards streams over every "
                   f"device"):
        assert dict(mesh.shape) == {"dp": n_devices}, mesh.shape
        rows = np.zeros((n_streams * 32 * 2, 64), np.int32)
        placed = parallel.serving_put(mesh, rows, 0)
        devs = {sh.device for sh in placed.addressable_shards}
        assert len(devs) == n_devices, devs
        print(f"  mesh {dict(mesh.shape)}: a {rows.shape} row plane lands "
              f"as {placed.addressable_shards[0].data.shape} on each of "
              f"{len(devs)} devices")
    with rep.phase(f"dryrun_multichip({n_devices})"):
        __graft_entry__.dryrun_multichip(n_devices)

    def parity(name, fn, streams, tol, **kw):
        ref, t1 = _timed(fn, streams, **kw)
        got, t2 = _timed(fn, streams, mesh=mesh, **kw)
        rep.time(f"{name} {len(streams)} streams, mesh=None first call", t1)
        rep.time(f"{name} {len(streams)} streams, {n_devices}-device mesh "
                 f"first call", t2)
        worst = 0
        for r, g in zip(ref, got):
            assert r.shape == g.shape, (r.shape, g.shape)
            worst = max(worst, _max_abs(r, g))
        assert worst <= tol, worst
        print(f"  {name}(mesh=): max |mesh - single| = {worst} LSB "
              f"(tolerance {tol} LSB)")

    with rep.phase("FLAC serving on the mesh"):
        parity("decode_flac_streams_device", decode_flac_streams_device,
               [b for _, b in flac_streams(n_streams, seconds, seed=3)], 0)
    with rep.phase("AAC-LC serving on the mesh"):
        parity("decode_aac_streams_device", AS.decode_aac_streams_device,
               [b"".join(f) for f in rotated_streams(
                   adts_frames("dryrun.aac"), n_streams,
                   int(seconds * RATE / 1024), 11)], 24)
    with rep.phase("HE-AAC serving on the mesh"):
        parity("decode_he_streams_device", AS.decode_he_streams_device,
               he_streams(n_streams, int(seconds * RATE / 2048)), 24)
    with rep.phase("MP3 serving on the mesh"):
        parity("decode_mp3_streams_device", decode_mp3_streams_device,
               [mp3_stream(700 + s, 200) for s in range(n_streams)], 24)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-device mesh path")
    args = ap.parse_args(argv)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from ohpipeline_jax import enable_compile_cache
    enable_compile_cache()
    card = card_label()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x "
          f"{dev.device_kind}", flush=True)
    rep = Report(card)
    t0 = time.perf_counter()
    if args.multichip:
        run_multichip(rep)
    else:
        run_single(rep)
    rep.time("whole run", time.perf_counter() - t0)
    if rep.failed:
        print(f"chip_smoke: failed phases: {rep.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.multichip else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
