#!/usr/bin/env python3
"""Time the LPC synthesis implementations on a GPU, alone and end to end.

    python tools/lpc_bench.py

Alone: the Pallas kernel (ops.lpc.lpc_synthesize_pallas) and XLA's
lax.scan reference, on the LPC rows of the
FLAC serving shape (16 streams x 32 frames x 2 channels x 4096
samples, parsed from chip_smoke.py's content).  End to end:
decode_flac_streams_device on chip_smoke.py's 16 x 30 s streams, and
the renderer (chip_smoke's PipelineManager.play_uri phase on a 20 s
FLAC file, then a CodecFlac decode of a 60 s file with a seek to its
middle), with each implementation in turns (kernel, scan, scan,
kernel): first call, then the median of three more.  Every result is
checked bit-exact against the first.  Times are medians of repeated
runs on the host clock around block_until_ready, printed with the
card's name and power limit.
"""

import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_time(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from ohpipeline_jax import enable_compile_cache, native
    from ohpipeline_jax.codecs.flac import frames as FF
    from ohpipeline_jax.codecs.flac.serving import decode_flac_streams_device
    from ohpipeline_jax.ops import lpc
    if jax.devices()[0].platform != "gpu":
        sys.exit("lpc_bench: needs a GPU")
    enable_compile_cache()
    card = chip_smoke.card_label()
    print(f"card: {card}", flush=True)
    streams = [b for _, b in chip_smoke.flac_streams(16, 30.0)]
    rows = {k: [] for k in ("data", "coeffs", "shift", "order")}
    for s in streams:
        si = FF.parse_metadata(s).streaminfo
        n, _, _, b = native.flac_parse_group(
            s, FF.parse_metadata(s).header_bytes * 8,
            sample_rate=si.sample_rate, bits_per_sample=si.bits_per_sample,
            max_blocksize=si.max_blocksize, channels=2, max_frames=32)
        for k in rows:
            rows[k].append(b[k][:n * 2])
    args = [jnp.asarray(np.concatenate(rows[k])) for k in rows]
    print(f"LPC rows {args[0].shape}", flush=True)
    ref = np.asarray(lpc.lpc_synthesize_scan(*args))
    impls = {"pallas kernel": lpc.lpc_synthesize_pallas,
             "lax.scan": lpc.lpc_synthesize_scan}
    for name, fn in impls.items():
        t0 = time.perf_counter()
        assert np.array_equal(np.asarray(fn(*args)), ref), name
        compile_s = time.perf_counter() - t0
        t = median_time(lambda: fn(*args).block_until_ready(), 10)
        print(f"[{card}] alone, {name}: {t * 1e3:.3f} ms "
              f"(first call {compile_s:.1f} s)", flush=True)

    pcm, blob = chip_smoke.flac_streams(1, 60.0, seed=8)[0]
    rep = chip_smoke.Report(card)
    want = None
    for which in ("kernel", "scan", "scan", "kernel"):
        jax.clear_caches()
        with (contextlib.nullcontext() if which == "kernel"
              else chip_smoke.lpc_scan_everywhere()):
            t0 = time.perf_counter()
            outs = decode_flac_streams_device(streams)
            first = time.perf_counter() - t0
            want = want or outs
            assert all(np.array_equal(a, b) for a, b in zip(outs, want))
            t = median_time(lambda: decode_flac_streams_device(streams), 3)
            print(f"[{card}] decode_flac_streams_device 16 x 30 s, "
                  f"{which}: {t:.3f} s (first call {first:.1f} s)",
                  flush=True)
            for k in range(2):
                t0 = time.perf_counter()
                chip_smoke.phase_renderer(rep, nframes=8, n=1024)
                print(f"[{card}] renderer phase (play_uri 20 s FLAC), "
                      f"{which}, call {k + 1}: "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
                t0 = time.perf_counter()
                decode_with_seek(blob, pcm)
                print(f"[{card}] CodecFlac 60 s with a seek to 30 s, "
                      f"{which}, call {k + 1}: "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
    assert not rep.failed, rep.failed


def decode_with_seek(blob, pcm):
    """Decode two groups of `blob`, seek to its middle, decode to the
    end; the samples after the seek must equal the source's tail."""
    from ohpipeline_jax.codecs import flac
    from ohpipeline_jax.codecs.base import BufferReader, EndOfStream
    codec = flac.CodecFlac()
    reader = BufferReader(blob)
    codec.stream_initialise(reader)
    for _ in range(2):
        codec.process(reader).resolve()
    pos = codec.try_seek(pcm.shape[1] // 2)
    assert reader.try_seek_bytes(pos)
    codec.notify_seek_done(pos)
    parts = []
    while True:
        try:
            parts.append(codec.process(reader).resolve())
        except EndOfStream:
            break
    tail = np.concatenate(parts, axis=1)
    assert np.array_equal(tail, pcm[:, pcm.shape[1] - tail.shape[1]:])


if __name__ == "__main__":
    main()
