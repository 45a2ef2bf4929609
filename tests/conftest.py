"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
exercised without accelerator hardware (mirrors how the reference tests
multi-node Songcast on loopback, SURVEY.md §4.6).  These env vars must be
set before jax is first imported anywhere in the test process.  An
explicit JAX_PLATFORMS is kept: `JAX_PLATFORMS=cuda python -m pytest -m
gpu tests/` runs the tests marked `gpu` on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

# Self-contained verification: the conformance suite's ground truth is
# the reference's vendored decoders compiled into .oracle_build/ by
# tools/build_oracles.sh.  Build any missing oracle NOW — at conftest
# import, before pytest imports the test modules — so the module-level
# `skipif(not ORACLE.exists())` guards see the built binaries.  Mirrors
# the reference's environment-complete suite
# (/root/reference/oncommit.test:36-89).  One-time cost on a fresh
# checkout (~minutes); a stat-check afterwards.
import importlib.util as _ilu

_spec = _ilu.spec_from_file_location(
    "ohp_oracles", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "oracles.py"))
_oracles = _ilu.module_from_spec(_spec)
_spec.loader.exec_module(_oracles)
_oracles.ensure_oracles()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xA4D10)


@pytest.fixture
def gpu():
    """The default backend's name, for tests marked `gpu`; skips unless
    it is a GPU (decided here, per test, never at import or collection,
    so every xdist worker collects the same tests)."""
    import jax
    platform = jax.default_backend()
    if platform != "gpu":
        pytest.skip(f"needs a GPU; the default backend is {platform}")
    return platform
