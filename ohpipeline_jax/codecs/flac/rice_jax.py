"""Device-side FLAC rice decode: the entropy-coded bytes ship to the
device and the rice codes are decoded there.

This displaces the reference's host bitreader for the batched serving
path (flac-1.2.1 src/libFLAC/bitreader.c, the hot loop under
stream_decoder.c) — instead of expanding residuals into byte planes on
the host CPU (flac_parse_group_zz) and paying ~1.5 bytes/sample on the
host->device copy, the copy carries the stream's own ~0.7 byte/sample
rice bits and the decode runs as a vectorized program on the device.

Parallelisation: rice codes are self-delimiting, so decode is sequential
*within* a run — but runs are small and plentiful.  The host parser
(native.flac_parse_group_rice) walks the codewords once (it must anyway,
to find frame boundaries) and emits "units": up to 64 consecutive
residuals sharing one rice parameter and a start bit cursor.  The device
then runs ONE lax.scan of 64 steps with one lane per unit (tens of
thousands of lanes per group): each step every lane loads a 32-bit
window at its bit cursor from the shared byte slab (two uint32 gathers),
priority-decodes the unary quotient via the float32-exponent trick,
extracts the k low bits, zigzags, and advances its cursor.

Aligned full units land in a dense (rows x stride/64) grid so the scan
output reshapes straight into the residual plane; partial/unaligned
units (warm-up heads, partition tails, escape splits) ride a small
overflow list applied with one scatter-add.  Codewords the 32-bit window
cannot hold (quotient > 15 or quotient+1+k > 32 bits) never reach the
device: the host escapes them as (row, pos, val) triples, exactly like
the plane wires.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

UNIT = 64          # samples per decode unit (matches flac_unpack.cc)


def _scan_units(words, cur, kk, mode, counts):
    """Decode one sample per step for every unit lane.

    words: (W,) uint32 big-endian view of the byte slab.
    cur: (U,) int32 bit cursors. kk: (U,) int32 rice parameter / raw
    width. mode: (U,) int32 0=rice 1=verbatim. counts: (U,) int32 valid
    samples. Returns (U, UNIT) int32 residuals (zeros past counts).
    """
    nw = words.shape[0]

    def step(cur, i):
        wi = (cur >> 5).astype(jnp.int32)
        w0 = words[jnp.clip(wi, 0, nw - 1)]
        w1 = words[jnp.clip(wi + 1, 0, nw - 1)]
        phase = (cur & 31).astype(jnp.uint32)
        wnd = jnp.where(phase > 0,
                        (w0 << phase)
                        | (w1 >> (jnp.uint32(32) - phase)), w0)
        # rice: unary quotient via clz of the top 16 bits (the host
        # guarantees quotient <= 15), stop bit, k low bits, zigzag
        top16 = (wnd >> 16).astype(jnp.int32)
        f = jax.lax.bitcast_convert_type(
            jnp.maximum(top16, 1).astype(jnp.float32), jnp.int32)
        unary = jnp.where(top16 > 0, 15 - ((f >> 23) - 127), 16)
        ku = kk.astype(jnp.uint32)
        low = jnp.where(
            kk > 0,
            (wnd << (unary.astype(jnp.uint32) + 1))
            >> (jnp.uint32(32) - ku), 0).astype(jnp.int32)
        zz = (unary << kk) | low
        rice_val = (zz >> 1) ^ -(zz & 1)
        # verbatim: kk raw bits, sign-extended (arithmetic shift)
        raw_val = jnp.where(
            kk > 0,
            jax.lax.bitcast_convert_type(wnd, jnp.int32)
            >> jnp.clip(32 - kk, 0, 31), 0)
        is_raw = mode == 1
        val = jnp.where(is_raw, raw_val, rice_val)
        adv = jnp.where(is_raw, kk, unary + 1 + kk)
        live = i < counts
        val = jnp.where(live, val, 0)
        cur = jnp.where(live, cur + adv, cur)
        return cur, val

    _, vals = jax.lax.scan(step, cur, jnp.arange(UNIT))
    return vals.T


def decode_units(bits_u8, gcur, gk, ocur, okk, omode, ocnt, orow, opos,
                 cfrow, cfval, cfn):
    """Residual plane (B, stride) int32 from the rice wire.

    bits_u8: (NB,) uint8 slab of raw stream bytes (NB % 4 == 0; pad with
    zeros).  gcur/gk: (B, stride//64) aligned-unit grid (gk = -1 empty).
    o*: overflow units with global rows/positions.  cf*: constant-
    subframe fills (row = -1 padding).
    """
    B, S = gcur.shape
    stride = S * UNIT
    padded = jnp.asarray(bits_u8).reshape(-1, 4).astype(jnp.uint32)
    words = ((padded[:, 0] << 24) | (padded[:, 1] << 16)
             | (padded[:, 2] << 8) | padded[:, 3])

    gk_f = gk.reshape(-1).astype(jnp.int32)
    cur = jnp.concatenate([gcur.reshape(-1), ocur]).astype(jnp.int32)
    kk = jnp.concatenate([jnp.maximum(gk_f, 0),
                          jnp.maximum(okk.astype(jnp.int32), 0)])
    counts = jnp.concatenate([jnp.where(gk_f < 0, 0, UNIT),
                              ocnt.astype(jnp.int32)])
    mode = jnp.concatenate([jnp.zeros(B * S, jnp.int32),
                            omode.astype(jnp.int32)])
    vals = _scan_units(words, cur, kk, mode, counts)

    res = vals[:B * S].reshape(B, stride)
    # overflow scatter-add: the grid slots under overflow rows are empty
    # (zeros), and masked lanes add 0 at index 0, so .add is exact
    ofv = vals[B * S:]
    O = ofv.shape[0]
    lane = jnp.arange(UNIT)[None, :]
    valid = (orow >= 0)[:, None] & (lane < ocnt.astype(jnp.int32)[:, None])
    idx = (jnp.clip(orow, 0, B - 1)[:, None] * stride
           + jnp.clip(opos[:, None] + lane, 0, stride - 1))
    idx = jnp.where(valid, idx, 0)
    add = jnp.where(valid, ofv, 0)
    res = res.reshape(-1).at[idx.reshape(-1)].add(
        add.reshape(-1)).reshape(B, stride)
    # constant-subframe fills
    cvalid = cfrow >= 0
    crow = jnp.where(cvalid, cfrow, 0)
    fill = jnp.where(cvalid[:, None]
                     & (jnp.arange(stride)[None, :] < cfn[:, None]),
                     cfval[:, None], 0)
    res = res.at[crow].add(fill)
    return res


@functools.partial(jax.jit, static_argnames=())
def decode_units_jit(*args):
    return decode_units(*args)
