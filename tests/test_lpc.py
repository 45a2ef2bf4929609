"""Bit-exactness tests for batched LPC residual synthesis.

The ground truth is a Python bigint implementation of the FLAC recurrence;
the lax.scan path and the Pallas kernel (interpret mode here, compiled
on a GPU) must match it exactly, including
worst-case magnitudes (25-bit samples, 15-bit coeffs, order 32, any shift).
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from ohpipeline_jax.ops import lpc


def _random_case(rng, B, N, max_order=32, sample_bits=17, coeff_bits=15,
                 max_shift=15, fixed_shift=None):
    """Random *stable* filters (sum|c| < 2^shift), like real encoded streams.

    Unconstrained random coefficients make an unstable IIR whose output
    overflows any fixed width; encoders only emit stable predictors.
    """
    data = rng.integers(-(1 << (sample_bits - 1)), 1 << (sample_bits - 1),
                        (B, N), dtype=np.int64).astype(np.int32)
    order = rng.integers(0, max_order + 1, (B,)).astype(np.int32)
    coeffs = np.zeros((B, lpc.MAX_ORDER), np.int32)
    shift = np.zeros((B,), np.int32)
    for b in range(B):
        o = order[b]
        shift[b] = (fixed_shift if fixed_shift is not None
                    else rng.integers(max(coeff_bits - 2, 1), max_shift + 1))
        if o == 0:
            continue
        c = rng.integers(-(1 << (coeff_bits - 1)),
                         1 << (coeff_bits - 1), (o,)).astype(np.float64)
        gain = np.abs(c).sum() / (1 << shift[b])
        if gain > 0.9:
            c = np.trunc(c * (0.9 / gain))
        coeffs[b, :o] = c.astype(np.int32)
    return data, coeffs, shift, order


def _check(data, coeffs, shift, order):
    truth = lpc.lpc_synthesize_py(data, coeffs, shift, order)
    assert np.abs(truth).max() < (1 << 31), "test case overflows int32 result"
    got = np.asarray(lpc.lpc_synthesize_scan(
        jnp.asarray(data), jnp.asarray(coeffs), jnp.asarray(shift),
        jnp.asarray(order)))
    np.testing.assert_array_equal(got.astype(np.int64), truth)
    return got


class TestScanBitExact:
    def test_random_batch(self, rng):
        _check(*_random_case(rng, B=16, N=64))

    def test_high_magnitude_24bit(self, rng):
        # 24-bit side-channel audio: samples to +-2^24, order 32, shift 0..15
        data, coeffs, shift, order = _random_case(
            rng, B=8, N=48, sample_bits=25, coeff_bits=15)
        _check(data, coeffs, shift, order)

    def test_worst_case_accumulator(self, rng):
        # Stress the 46-bit accumulator directly: order-32 filter with
        # max-magnitude coeffs against max-magnitude 25-bit warm-up samples,
        # only two synthesized samples so the output can't run away.
        B = 8
        order = np.full((B,), 32, np.int32)
        N = 34
        data = np.zeros((B, N), np.int32)
        signs = rng.integers(0, 2, (B, 32)) * 2 - 1
        data[:, :32] = signs * ((1 << 24) - 1)
        coeffs = (rng.integers(0, 2, (B, 32)) * 2 - 1) * ((1 << 14) - 1)
        coeffs = coeffs.astype(np.int32)
        # shift large enough that the shifted prediction fits int32
        shift = np.full((B,), 15, np.int32)
        truth = lpc.lpc_synthesize_py(data, coeffs, shift, order)
        assert np.abs(truth).max() < (1 << 31)
        _check(data, coeffs, shift, order)

    def test_shift_extremes(self, rng):
        for sh in (0, 1, 12, 13, 24, 25, 31):
            data, coeffs, shift, order = _random_case(
                rng, B=4, N=32, sample_bits=12, coeff_bits=6, fixed_shift=sh)
            _check(data, coeffs, shift, order)

    def test_fixed_predictors(self, rng):
        # FLAC fixed subframes: orders 0-4, shift 0.
        B, N = 5, 40
        data = rng.integers(-1000, 1000, (B, N)).astype(np.int32)
        coeffs = np.zeros((B, lpc.MAX_ORDER), np.int32)
        order = np.arange(5, dtype=np.int32)
        for b in range(B):
            c = lpc.FIXED_COEFFS[b]
            coeffs[b, :len(c)] = c
        shift = np.zeros((B,), np.int32)
        _check(data, coeffs, shift, order)

    def test_order_zero_is_identity(self, rng):
        B, N = 3, 16
        data = rng.integers(-100, 100, (B, N)).astype(np.int32)
        z = np.zeros((B,), np.int32)
        got = _check(data, np.zeros((B, lpc.MAX_ORDER), np.int32), z, z)
        np.testing.assert_array_equal(got, data)

    def test_known_first_order(self):
        # s[n] = r[n] + s[n-1] (order 1, c=[1], shift 0) => cumulative sum
        data = np.array([[5, 1, 2, 3, 4]], np.int32)
        coeffs = np.zeros((1, lpc.MAX_ORDER), np.int32)
        coeffs[0, 0] = 1
        out = _check(data, coeffs, np.zeros(1, np.int32),
                     np.ones(1, np.int32))
        np.testing.assert_array_equal(out[0], [5, 6, 8, 11, 15])

    def test_negative_accumulator_floor(self):
        # floor division on negative accumulators must round toward -inf
        # (arithmetic shift), e.g. c*s = -3, shift 1 -> -2 not -1.
        data = np.array([[3, 0, 0, 0]], np.int32)
        coeffs = np.zeros((1, lpc.MAX_ORDER), np.int32)
        coeffs[0, 0] = -1
        shift = np.ones(1, np.int32)
        order = np.ones(1, np.int32)
        _check(data, coeffs, shift, order)


def _cases(rng):
    """The scan suite's cases, as (name, data, coeffs, shift, order)."""
    out = [("random",) + _random_case(rng, B=40, N=37, sample_bits=20),
           ("24bit",) + _random_case(rng, B=8, N=48, sample_bits=25,
                                     coeff_bits=15)]
    B = 8
    data = np.zeros((B, 34), np.int32)
    data[:, :32] = (rng.integers(0, 2, (B, 32)) * 2 - 1) * ((1 << 24) - 1)
    coeffs = ((rng.integers(0, 2, (B, 32)) * 2 - 1)
              * ((1 << 14) - 1)).astype(np.int32)
    out.append(("worst_accumulator", data, coeffs,
                np.full((B,), 15, np.int32), np.full((B,), 32, np.int32)))
    parts = [_random_case(rng, B=4, N=32, sample_bits=12, coeff_bits=6,
                          fixed_shift=sh) for sh in (0, 1, 12, 13, 24, 25, 31)]
    out.append(("shift_extremes",) + tuple(np.concatenate(p) for p in
                                           zip(*parts)))
    fixed = np.zeros((5, lpc.MAX_ORDER), np.int32)
    for b in range(5):
        fixed[b, :len(lpc.FIXED_COEFFS[b])] = lpc.FIXED_COEFFS[b]
    out.append(("fixed_predictors",
                rng.integers(-1000, 1000, (5, 40)).astype(np.int32), fixed,
                np.zeros((5,), np.int32), np.arange(5, dtype=np.int32)))
    return out


CASES = ("random", "24bit", "worst_accumulator", "shift_extremes",
         "fixed_predictors")


def _case(name):
    return {c[0]: c[1:] for c in _cases(np.random.default_rng(0xA4D10))}[name]


class TestPallasInterpret:
    """The GPU kernel (Pallas through Triton): its arithmetic in
    interpret mode on the CPU, its padding and shapes, and the choice of
    kernel by platform."""

    @pytest.mark.parametrize("name", CASES)
    def test_interpret_matches_oracle(self, name):
        data, coeffs, shift, order = _case(name)
        want = lpc.lpc_synthesize_py(data, coeffs, shift, order)
        got = lpc.lpc_synthesize_pallas(data, coeffs, shift, order,
                                        interpret=True)
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                      want)

    @pytest.mark.parametrize("B,N", [(5, 13), (64, 16), (33, 9)])
    def test_padding_and_shapes(self, rng, B, N):
        import jax
        data, coeffs, shift, order = _random_case(rng, B=B, N=N,
                                                  sample_bits=16)
        f = functools.partial(lpc.lpc_synthesize_pallas, interpret=True)
        jaxpr = jax.make_jaxpr(f)(data, coeffs, shift, order)
        calls = [e for e in jaxpr.jaxpr.eqns[0].params["jaxpr"].eqns
                 if e.primitive.name == "pallas_call"]
        assert len(calls) == 1
        block_rows, unroll = lpc.BLOCK_ROWS, lpc.UNROLL
        Bp = -(-B // block_rows) * block_rows
        Np = -(-N // unroll) * unroll
        # time-major padded operands, one program per row block
        assert [v.aval.shape for v in calls[0].invars] == [
            (Np + unroll, Bp), (lpc.MAX_ORDER, Bp), (Bp,), (Bp,)]
        assert calls[0].outvars[0].aval.shape == (Np, Bp)
        assert calls[0].params["grid_mapping"].grid == (Bp // block_rows,)
        got = np.asarray(f(data, coeffs, shift, order))
        assert got.shape == (B, N) and got.dtype == np.int32
        np.testing.assert_array_equal(
            got.astype(np.int64),
            lpc.lpc_synthesize_py(data, coeffs, shift, order))

    @pytest.mark.parametrize("platform,want", [
        ("gpu", "lpc_synthesize_pallas"), ("cpu", "lpc_synthesize_scan")])
    def test_kernel_choice_by_platform(self, platform, want):
        assert lpc.kernel_for(platform) is getattr(lpc, want)

    def test_dispatcher_on_cpu_uses_scan(self, rng):
        data, coeffs, shift, order = _random_case(rng, B=4, N=16)
        got = lpc.lpc_synthesize(jnp.asarray(data), jnp.asarray(coeffs),
                                 jnp.asarray(shift), jnp.asarray(order))
        want = lpc.lpc_synthesize_py(data, coeffs, shift, order)
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)

    @pytest.mark.parametrize("name", CASES)
    def test_kernel_matches_scan(self, name):
        """The kernel in interpret mode against the scan it replaces on
        the GPU, bit for bit."""
        args = [jnp.asarray(a) for a in _case(name)]
        np.testing.assert_array_equal(
            np.asarray(lpc.lpc_synthesize_pallas(*args, interpret=True)),
            np.asarray(lpc.lpc_synthesize_scan(*args)))


@pytest.mark.gpu
class TestKernelOnGpu:
    """The compiled kernel on the card (no interpret mode), against the
    bigint oracle and through the default dispatch."""

    @pytest.mark.parametrize("name", CASES)
    def test_compiled_matches_oracle(self, gpu, name):
        data, coeffs, shift, order = _case(name)
        got = lpc.lpc_synthesize(jnp.asarray(data), jnp.asarray(coeffs),
                                 jnp.asarray(shift), jnp.asarray(order))
        np.testing.assert_array_equal(
            np.asarray(got).astype(np.int64),
            lpc.lpc_synthesize_py(data, coeffs, shift, order))

    def test_dispatch_picks_kernel(self, gpu):
        assert lpc.kernel_for(gpu) is lpc.lpc_synthesize_pallas
