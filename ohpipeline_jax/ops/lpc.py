"""Batched, bit-exact LPC residual synthesis — the decode core of FLAC and
ALAC, and of the fixed predictors both share.

The recurrence (FLAC spec; reference behaviour: flac-1.2.1
`FLAC__lpc_restore_signal{,_wide}` called from
OpenHome/Media/Codec/Flac.cpp's libFLAC callbacks):

    s[n] = r[n] + floor( sum_{i=1..order} c[i] * s[n-i]  /  2**shift )

with integer coefficients `c` (quantized precision <= 15 bits) and warm-up
samples s[0..order) stored verbatim.  The accumulator needs up to ~46 bits
(24-bit audio, order 32), beyond int32.  JAX truncates `jnp.int64` to
int32 unless `jax_enable_x64` is set, which this package does not set, so
the dot product is computed in three 12-bit limbs with carry
normalisation, which is exact for |samples| < 2**25 and |coeffs| <= 2**14
at any order <= 32.

Why this shape: every FLAC/ALAC subframe carries its own warm-up samples, so
*all subframes of all streams decode independently* — the batch axis B is
"subframes in flight" and is large (a 3-minute stereo track alone is ~4k
subframes).  Within a subframe the floor() makes the recurrence inherently
sequential over N.  Parallelism comes from B, not N.

Layouts:
    data   (B, N) int32 — warm-up samples in positions [0, order_b), residuals
                          from position order_b on.  Constant/verbatim
                          subframes use order=0 with data = the samples.
    coeffs (B, 32) int32 — c[1..order] zero-padded; coeffs[b, i] multiplies
                          s[n-1-i].
    shift  (B,) int32   — in [0, 31].
    order  (B,) int32   — in [0, 32].
Returns (B, N) int32 reconstructed samples.

`lpc_synthesize` is the one entry every caller uses.  On a GPU it runs the
Pallas kernel below (through Triton); elsewhere it runs
`lpc_synthesize_scan`, the plain XLA reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

MAX_ORDER = 32
_LIMB = 12
_MASK = (1 << _LIMB) - 1

# |sample| bound for which the 3x12-bit limb accumulation is exact.
MAX_SAMPLE_BITS = 25
MAX_COEFF_BITS = 15  # signed quantized-LPC precision


def _split_limbs(x):
    """Split int32 x into (lo, mid, hi): x == hi*2^24 + mid*2^12 + lo,
    lo/mid in [0, 2^12), hi signed."""
    lo = x & _MASK
    mid = (x >> _LIMB) & _MASK
    hi = x >> (2 * _LIMB)
    return lo, mid, hi


def _shift_amounts(s):
    """Per-row shift amounts of `_exact_shifted_dot`, each clipped to
    [0, 31] so no shift is undefined: (a2 left, a1 left, a0 right,
    a1 right, a2 right)."""
    return (jnp.clip(24 - s, 0, 31), jnp.clip(12 - s, 0, 31),
            jnp.clip(s, 0, 31), jnp.clip(s - 12, 0, 31),
            jnp.clip(s - 24, 0, 31))


def _exact_shifted_dot(p0_sum, p1_sum, p2_sum, shift, amounts=None):
    """floor((p2_sum*2^24 + p1_sum*2^12 + p0_sum) / 2^shift), exact in int32.

    The three partial sums are int32 (each |.| < 2^31 by the limb bounds);
    the true value may exceed 32 bits but the final shifted result must fit
    int32 (guaranteed for valid streams).  Wrapping int32 adds/shifts then
    yield the exact result modulo 2^32 == the exact result.  `amounts` is
    `_shift_amounts(shift)`, passed in where it is loop-invariant.
    """
    l24, l12, r0, r12, r24 = amounts or _shift_amounts(shift)
    c1 = p0_sum >> _LIMB
    a0 = p0_sum & _MASK
    p1 = p1_sum + c1
    c2 = p1 >> _LIMB
    a1 = p1 & _MASK
    a2 = p2_sum + c2
    # acc == a2*2^24 + a1*2^12 + a0, with a0, a1 in [0, 2^12).
    lo_branch = (a2 << l24) + (a1 << l12) + (a0 >> r0)
    mid_branch = (a2 << l24) + (a1 >> r12)
    hi_branch = a2 >> r24
    return jnp.where(shift <= 12, lo_branch,
                     jnp.where(shift <= 24, mid_branch, hi_branch))


# ---------------------------------------------------------------------------
# Plain XLA reference (lax.scan) — runs on any backend.
# ---------------------------------------------------------------------------

@jax.jit
def lpc_synthesize_scan(data, coeffs, shift, order):
    """Reference implementation via lax.scan over samples.

    Bit-exact; the CPU path, and the oracle for the GPU kernel.
    """
    B, N = data.shape
    data = data.astype(jnp.int32)
    coeffs = coeffs.astype(jnp.int32)
    shift2 = shift.astype(jnp.int32)[:, None]          # (B, 1)
    order2 = order.astype(jnp.int32)[:, None]          # (B, 1)

    # history limbs, most recent first: h*[b, i] are limbs of s[n-1-i]
    h0 = jnp.zeros((B, MAX_ORDER), jnp.int32)
    h1 = jnp.zeros((B, MAX_ORDER), jnp.int32)
    h2 = jnp.zeros((B, MAX_ORDER), jnp.int32)

    def step(carry, dn):
        h0, h1, h2, n = carry
        p0 = jnp.sum(coeffs * h0, axis=1, keepdims=True)
        p1 = jnp.sum(coeffs * h1, axis=1, keepdims=True)
        p2 = jnp.sum(coeffs * h2, axis=1, keepdims=True)
        pred = _exact_shifted_dot(p0, p1, p2, shift2)
        y = dn[:, None] + pred
        out = jnp.where(n < order2, dn[:, None], y)     # warm-up passthrough
        o0, o1, o2 = _split_limbs(out)
        h0 = jnp.concatenate([o0, h0[:, :-1]], axis=1)
        h1 = jnp.concatenate([o1, h1[:, :-1]], axis=1)
        h2 = jnp.concatenate([o2, h2[:, :-1]], axis=1)
        return (h0, h1, h2, n + 1), out[:, 0]

    (_, _, _, _), out = jax.lax.scan(step, (h0, h1, h2, jnp.int32(0)),
                                     data.T)
    return out.T


# ---------------------------------------------------------------------------
# GPU kernel (Pallas through Triton)
# ---------------------------------------------------------------------------

#: rows per program and warps per program: one row per thread, so each
#: thread keeps its row's whole history in registers
BLOCK_ROWS = 32
NUM_WARPS = 1
#: samples per loop iteration; the next iteration's residual rows are
#: loaded while this one computes
UNROLL = 8


def _tree_sum(xs):
    xs = list(xs)
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] if i + 1 < len(xs) else xs[i]
              for i in range(0, len(xs), 2)]
    return xs[0]


def _lpc_kernel(data_ref, coeffs_ref, shift_ref, order_ref, out_ref):
    """One program: `BLOCK_ROWS` subframes, all of their samples.

    Refs are time-major (sample, row), so every step loads and stores one
    contiguous row vector.  The 32-deep history lives in registers as 3 x
    32 limb vectors, shifted by renaming (a Python tuple), since Triton
    cannot index registers dynamically; nothing carries between programs.
    """
    n_chunks = out_ref.shape[0] // UNROLL
    c = [coeffs_ref[i, :] for i in range(MAX_ORDER)]
    shift = shift_ref[...]
    order = order_ref[...]
    amounts = _shift_amounts(shift)
    zero = jnp.zeros_like(shift)

    def dot(h):
        # the newest sample's term last: it is the only one on the
        # step-to-step dependency chain
        return _tree_sum(c[i] * h[i] for i in range(1, MAX_ORDER)) \
            + c[0] * h[0]

    def chunk(t, carry):
        h0, h1, h2, rows = carry
        base = t * UNROLL
        # prefetch: data_ref holds `UNROLL` zero rows past the output
        nxt = tuple(data_ref[base + UNROLL + u, :] for u in range(UNROLL))
        for u in range(UNROLL):
            pred = _exact_shifted_dot(dot(h0), dot(h1), dot(h2), shift,
                                      amounts)
            dn = rows[u]
            out = jnp.where(base + u < order, dn, dn + pred)
            out_ref[base + u, :] = out
            o0, o1, o2 = _split_limbs(out)
            h0 = (o0,) + h0[:-1]
            h1 = (o1,) + h1[:-1]
            h2 = (o2,) + h2[:-1]
        return h0, h1, h2, nxt

    hist = (zero,) * MAX_ORDER
    rows0 = tuple(data_ref[u, :] for u in range(UNROLL))
    jax.lax.fori_loop(0, n_chunks, chunk, (hist, hist, hist, rows0))


@functools.partial(jax.jit, static_argnames=("interpret",))
def lpc_synthesize_pallas(data, coeffs, shift, order, *, interpret=False):
    """The GPU kernel; same contract as `lpc_synthesize_scan`.

    Pads B to a multiple of `BLOCK_ROWS` with inert subframes (order 0)
    and N to a multiple of `UNROLL` with zero residuals, both sliced off
    the result.  `interpret=True` runs it on the CPU for tests.
    """
    B, N = data.shape
    Bp = -(-B // BLOCK_ROWS) * BLOCK_ROWS
    Np = -(-N // UNROLL) * UNROLL
    # + `UNROLL` zero rows that the last iteration's prefetch reads
    data_t = jnp.pad(data.astype(jnp.int32).T,
                     ((0, Np - N + UNROLL), (0, Bp - B)))
    coeffs_t = jnp.pad(coeffs.astype(jnp.int32).T, ((0, 0), (0, Bp - B)))
    shift_p = jnp.pad(shift.astype(jnp.int32), (0, Bp - B))
    order_p = jnp.pad(order.astype(jnp.int32), (0, Bp - B))

    out = pl.pallas_call(
        _lpc_kernel,
        out_shape=jax.ShapeDtypeStruct((Np, Bp), jnp.int32),
        grid=(Bp // BLOCK_ROWS,),
        in_specs=[
            pl.BlockSpec((Np + UNROLL, BLOCK_ROWS), lambda i: (0, i)),
            pl.BlockSpec((MAX_ORDER, BLOCK_ROWS), lambda i: (0, i)),
            pl.BlockSpec((BLOCK_ROWS,), lambda i: (i,)),
            pl.BlockSpec((BLOCK_ROWS,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((Np, BLOCK_ROWS), lambda i: (0, i)),
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="lpc_synthesize",
        cost_estimate=pl.CostEstimate(
            flops=6 * MAX_ORDER * Bp * Np, transcendentals=0,
            bytes_accessed=2 * 4 * Bp * Np),
    )(data_t, coeffs_t, shift_p, order_p)
    return out[:N, :B].T


def kernel_for(platform: str):
    """The synthesis function `lpc_synthesize` uses on `platform`
    (a `jax.default_backend()` name)."""
    return lpc_synthesize_pallas if platform == "gpu" \
        else lpc_synthesize_scan


def lpc_synthesize(data, coeffs, shift, order):
    """Bit-exact LPC synthesis on the default backend: the Pallas kernel on
    a GPU (a kernel that fails to compile raises), the lax.scan reference
    elsewhere."""
    return kernel_for(jax.default_backend())(data, coeffs, shift, order)


# ---------------------------------------------------------------------------
# Python/bigint oracle for tests (arbitrary precision; the ground truth).
# ---------------------------------------------------------------------------

def lpc_synthesize_py(data: np.ndarray, coeffs: np.ndarray, shift: np.ndarray,
                      order: np.ndarray) -> np.ndarray:
    out = np.zeros_like(data, dtype=object)
    B, N = data.shape
    for b in range(B):
        o, sh = int(order[b]), int(shift[b])
        c = [int(v) for v in coeffs[b, :o]]
        for n in range(N):
            if n < o:
                out[b, n] = int(data[b, n])
            else:
                acc = sum(c[i] * int(out[b, n - 1 - i]) for i in range(o))
                out[b, n] = int(data[b, n]) + (acc >> sh)
    return out.astype(np.int64)


#: Fixed-predictor coefficients shared by FLAC and the flywheel ramp
#: (FLAC spec §fixed subframe; orders 0-4, shift 0).
FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}
