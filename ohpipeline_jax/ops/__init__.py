"""Device kernels: all the dense math of the framework.

Everything in this package is pure JAX (jit-able, shardable); the one
Pallas kernel (lpc) runs on GPUs, with its plain XLA reference on the CPU.
"""

from .lpc import lpc_synthesize, lpc_synthesize_scan

__all__ = ["lpc_synthesize", "lpc_synthesize_scan"]
