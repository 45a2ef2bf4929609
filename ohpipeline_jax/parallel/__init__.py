"""Multi-device scaling of the batched decode/render path.

The reference scales by threads-within-one-box (SURVEY.md §2.7); this
build scales across a `jax.sharding.Mesh`:

one `dp` axis over every device: streams are the natural data
parallelism (every FLAC subframe batch row is independent), and the LPC
recurrence stays whole-row (it is sequential in time).

Multiroom: decoded master-room audio is broadcast to every device with
collectives instead of UDP multicast — `room_fanout` below all-gathers
the master shard so each device holds the full master mix, mirroring OHM
fan-out semantics (Av/Songcast/OhmSender).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import lpc as lpc_ops
from ..ops import pcm as pcm_ops


def make_mesh(n_devices: int | None = None) -> Mesh:
    """Build the 1D `dp` mesh over the first `n_devices` devices (all by
    default): streams are the parallelism of every serving path, and the
    devices of one host are joined all to all, so the mesh follows the
    algorithm, not a physical topology."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("dp",))


def serving_put(mesh, arr, stream_axis: int | None = None):
    """Place one serving-call array for stream-parallel mesh execution.

    The multi-stream serving entry points (codecs/*/serving.py
    decode_*_streams_device) batch independent streams along one axis;
    under a mesh, that axis shards over ``dp`` (SURVEY §2.7: stream
    concurrency = batch parallelism across decode streams) while shared
    wire planes (entropy-coded bytes, escape/side lists, device
    constants) replicate — any row may address any offset in them.
    XLA compiles the same jitted program with these input shardings and
    inserts the collectives.

    ``stream_axis=None`` or a non-divisible axis extent replicates.
    ``mesh=None`` is the single-device fast path (no placement)."""
    if mesh is None:
        return arr
    import jax
    a = np.asarray(arr) if not hasattr(arr, "sharding") else arr
    spec = [None] * a.ndim
    dp = mesh.shape["dp"]
    if stream_axis is not None and a.ndim > stream_axis \
            and a.shape[stream_axis] >= dp \
            and a.shape[stream_axis] % dp == 0:
        spec[stream_axis] = "dp"
    return jax.device_put(a, NamedSharding(mesh, P(*spec)))


def decode_render_step(data, coeffs, shift, order, wasted, assign,
                       ramp_start, ramp_end, gain, num_channels: int = 2):
    """The flagship fused step: FLAC-family subframe batch -> rendered PCM.

    Per group of frames (B = F * num_channels rows of subframe data):
    LPC residual synthesis -> wasted-bit shift -> inter-channel
    decorrelation -> fused ramp x volume gain chain.  Returns
    (F, num_channels, N) int32 PCM plus per-frame peak meters (F,) used by
    observers (Reporter equivalent).
    """
    synth = lpc_ops.lpc_synthesize(data, coeffs, shift, order)
    synth = jnp.left_shift(synth, wasted[:, None])
    B, N = data.shape
    F_ = B // num_channels
    chans = synth.reshape(F_, num_channels, N)
    if num_channels == 2:
        mode = jnp.where(assign == 8, pcm_ops.CH_LEFT_SIDE,
                         jnp.where(assign == 9, pcm_ops.CH_RIGHT_SIDE,
                                   jnp.where(assign == 10, pcm_ops.CH_MID_SIDE,
                                             pcm_ops.CH_INDEPENDENT)))
        left, right = pcm_ops.stereo_decorrelate(chans[:, 0], chans[:, 1],
                                                 mode)
        chans = jnp.stack([left, right], axis=1)
    rendered = pcm_ops.apply_gain(chans, ramp_start, ramp_end, gain)
    peaks = jnp.max(jnp.abs(rendered), axis=(1, 2))
    return rendered, peaks


def example_step_args(nframes: int = 8, n: int = 1024, num_channels: int = 2,
                      seed: int = 0):
    """Small, realistic example inputs for compile checks."""
    rng = np.random.default_rng(seed)
    B = nframes * num_channels
    data = rng.integers(-1000, 1000, size=(B, n)).astype(np.int32)
    coeffs = np.zeros((B, lpc_ops.MAX_ORDER), np.int32)
    coeffs[:, :4] = [4, -6, 4, -1]
    shift = np.zeros(B, np.int32)
    order = np.full(B, 4, np.int32)
    wasted = np.zeros(B, np.int32)
    assign = np.full(nframes, 10, np.int32)   # mid/side
    ramp_start = np.ones(nframes, np.float32)
    ramp_end = np.ones(nframes, np.float32)
    gain = np.full(nframes, 0.8, np.float32)
    return (data, coeffs, shift, order, wasted, assign, ramp_start,
            ramp_end, gain)


def room_fanout(mesh: Mesh, x):
    """OHM-style multiroom fan-out as a collective (the Songcast
    OhmSender analogue, Av/Songcast/OhmSender — SURVEY.md §2.7/§5.8):
    master audio (or meters) sharded over `dp` is all-gathered so every
    device ("room") holds the full master mix.  Returns (full, peak):
    the replicated array plus its peak meter.  Used by both the
    sharded pipeline step and the multi-device dryrun."""
    spec = P("dp", *([None] * (x.ndim - 1))) if x.ndim else P()
    x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
    full = jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P()))        # all-gather to every room
    return full, jnp.max(jnp.abs(full))


def room_render_grid(mesh: Mesh, master, gains, delays, skew_ppm,
                     ramp0, ramp1):
    """Per-room pipeline render chain over the mesh — the receiver half
    of multiroom (SURVEY.md §2.7/§5.8).

    The reference's Songcast receivers each run their own pipeline tail
    on the shared master mix: a VariableDelay aligns latency
    (Media/Pipeline/VariableDelay.cpp), ClockPullerSongcast trims the
    receiver clock against the sender's timestamps (fractional-rate
    resample), and the local volume/ramp chain scales the result.  Here
    the rooms ARE mesh devices: `master` is replicated (the fan-out
    collective, `room_fanout`) and every room's chain — fractional delay + clock-skew
    linear resample + linear ramp x gain — runs sharded P('dp') over
    rooms inside one SPMD program.

    master: (C, N) float32 master mix (replicated).
    gains, delays, skew_ppm, ramp0, ramp1: (R,) per-room parameters
    (gain scalar; delay in samples, may be fractional; clock skew in
    ppm; ramp endpoints) — sharded over `dp`.
    Returns (R, C, N) per-room PCM sharded P('dp', None, None).
    """
    C, N = master.shape
    t = jnp.arange(N, dtype=jnp.float32)

    def one_room(gain, delay, skew, r0, r1):
        # clock-skew resample + fractional delay in one gather: the room
        # clock runs (1 + skew*1e-6) x the sender clock, shifted by the
        # room's latency-alignment delay
        pos = t * (1.0 + skew * 1e-6) - delay
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, N - 1)
        i1 = jnp.clip(i0 + 1, 0, N - 1)
        frac = pos - i0.astype(jnp.float32)
        x = master[:, i0] * (1.0 - frac) + master[:, i1] * frac
        x = jnp.where((pos < 0.0) | (pos > N - 1.0), 0.0, x)
        ramp = r0 + (r1 - r0) * t * (1.0 / N)
        return x * (gain * ramp)

    dp_vec = NamedSharding(mesh, P("dp"))
    out = jax.vmap(one_room)(
        *(jax.lax.with_sharding_constraint(jnp.asarray(a, jnp.float32),
                                           dp_vec)
          for a in (gains, delays, skew_ppm, ramp0, ramp1)))
    return jax.lax.with_sharding_constraint(
        out, NamedSharding(mesh, P("dp", None, None)))


def sharded_pipeline_step(mesh: Mesh, num_channels: int = 2):
    """jit the full decode->render->multiroom step over `mesh`.

    Shardings: subframe batch rows over `dp` (stream parallelism);
    `room_fanout` all-gathers per-device peak meters (a collective
    standing in for Songcast's UDP fan-out).
    """
    dp_rows = NamedSharding(mesh, P("dp", None))
    dp_vec = NamedSharding(mesh, P("dp"))

    def step(data, coeffs, shift, order, wasted, assign, ramp_start,
             ramp_end, gain, aac_spec, aac_opidx, aac_overlap,
             vorbis_spec):
        # stage 1: FLAC-family decode + render (stream/dp parallel)
        rendered, peaks = decode_render_step(
            data, coeffs, shift, order, wasted, assign, ramp_start,
            ramp_end, gain, num_channels=num_channels)
        # stage 2: AAC filterbank over the same mesh (rows over dp)
        from ..codecs.aac import synthesis as ASYN
        W, SW = ASYN.window_bank()
        aac_pcm, aac_ov = ASYN.filterbank_fast(
            aac_spec, aac_opidx, aac_overlap,
            jnp.asarray(ASYN._imdct_matrix(2048)),
            jnp.asarray(ASYN._imdct_matrix(256)),
            jnp.asarray(W), jnp.asarray(SW))
        # stage 3: Vorbis IMDCT (rows over dp)
        from ..codecs.vorbis import synthesis as VSYN
        vorbis_time = jnp.matmul(
            vorbis_spec, jnp.asarray(VSYN._imdct_op(2048)),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        # multiroom fan-out: every device sees the whole room's meters
        room_meters, _peak = room_fanout(mesh, peaks)
        return rendered, room_meters, aac_pcm, aac_ov, vorbis_time

    aac_sh = NamedSharding(mesh, P(None, "dp", None))
    in_sh = ((dp_rows,) * 2 + (dp_vec,) * 3 + (dp_vec,) * 4
             + (aac_sh, NamedSharding(mesh, P(None, "dp")),
                NamedSharding(mesh, P("dp", None)), dp_rows))
    return jax.jit(step, in_shardings=in_sh)
