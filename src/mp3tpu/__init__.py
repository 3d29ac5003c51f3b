"""mp3tpu — a batched MP3 decode/encode/playback framework on JAX.

Built from scratch against ISO/IEC 11172-3 (MPEG-1 Audio Layer III), with
the LSF extension (ISO/IEC 13818-3, MPEG-2/2.5) for decode. The reference
project (lxm0851/mp3) ships no source; see SURVEY.md for the capability
blueprint this framework implements.

Architecture: variable-length, branchy bitstream work (sync scan, side
info, scalefactors, Huffman) runs on host and is packed into dense
SymbolTensors; all per-granule DSP (requantize -> stereo -> reorder ->
alias -> IMDCT/overlap -> polyphase synthesis) runs on the accelerator
as batched JAX/XLA programs over [stream, granule, channel, ...] tensors.
"""

__version__ = "0.1.0"

import os as _os

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))


def compile_cache_dir() -> str | None:
    """Directory of the persistent XLA compilation cache.

    JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself).
    Otherwise a source checkout caches in its own fixed `.jax_cache`
    directory (git-ignored), so every process run from the checkout
    reuses the same compiles; an installed package sets none."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if _os.path.exists(_os.path.join(_CHECKOUT, "pyproject.toml")):
        return _os.path.join(_CHECKOUT, ".jax_cache")
    return None


def _enable_jit_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir():
    first-run compiles of the decode and encode programs are reused
    across processes (the cure for the reference player's cold-start
    glitch, SURVEY.md §3.5). Programs that compile in 0.5 s or more are
    kept (JAX's default keeps only those of 1 s or more)."""
    cache = compile_cache_dir()
    if cache is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_jit_cache()

from .api import (decode, decode_batch, encode, encode_batch,  # noqa: F401
                  global_metrics, init, levels, levels_batch, loudness, play,
                  segment, segment_batch, split, transcode_batch)


def __getattr__(name):
    # lazy: DecodedBatch lives in pipeline, which pulls in jax/kernels —
    # keep `import mp3tpu` light (api functions import on first call)
    if name == "DecodedBatch":
        from .pipeline import DecodedBatch
        return DecodedBatch
    raise AttributeError(name)
