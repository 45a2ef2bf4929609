"""ohpipeline_jax — an accelerator-batched audio streaming framework.

A brand-new framework with the capabilities of openhome/ohPipeline (the
OpenHome `ohMediaPlayer` audio renderer), re-designed around a batched
device decode:

* Control plane, stream protocols, container parsing and bitstream entropy
  decode run host-side (Python orchestration + C++ unpackers).
* All dense math — codec synthesis (LPC residual synthesis, IMDCT, polyphase
  filterbanks) and every PCM transform (format conversion, ramps, volume,
  mute, aggregation, latency trimming) — runs as batched JAX/XLA/Pallas
  programs so many streams decode in parallel per device.
* Multi-device scaling uses `jax.sharding.Mesh` + collectives, not host
  threads.

Subpackages
-----------
core       timebase (jiffies), stream-event model, audio tiles, ramp spec
ops        device kernels: LPC synthesis, IMDCT, filterbanks, PCM DSP
codecs     FLAC/WAV/AIFF/PCM/ALAC/MP3/AAC/Vorbis/Opus/DSD decode paths
containers ID3v2 / MP4 (ISO-BMFF) / MPEG-TS / Ogg framing
protocols  file/tone/http/icy/hls/dash stream sources
pipeline   reservoirs, pipeline elements, manager, filler (pull model)
parallel   device-mesh sharding of the batched decode/DSP path
av         product/source/volume/config media-player layer
native     C++ host helpers (bitstream unpack) loaded via ctypes
"""

import os

__version__ = "0.1.0"

#: the checkout (or install) directory holding this package
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> None:
    """Keep JAX's persistent compile cache in `<ROOT>/.jax_cache`, so
    repeat processes skip recompilation.  Sets nothing when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that itself) or a cache
    directory is already configured."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(ROOT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
