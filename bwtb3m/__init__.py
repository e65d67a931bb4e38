"""bwtb3m — BWT / FM-index construction on an accelerator, in JAX.

A from-scratch rebuild of the capabilities of gt1/bwtb3m (Burrows-Wheeler
Transform By Balanced Block Merging) designed for JAX / XLA rather than
ported from the reference's C++/libmaus2/OpenMP architecture.

Reference semantics implemented (reference README "Output"):
the BWT is defined on the *circular* text (no terminator is appended; suffix
comparison wraps around), run-length encoded on disk, accompanied by a symbol
histogram, rank/position samples (preisa) and sampled suffix / inverse suffix
arrays.

Layer map (SURVEY.md section 1, redesigned for a device):

  io/       on-disk formats + input types (compact k-bit, pac/pacterm, RL-BWT,
            .hist/.preisa/.sa/.isa, FASTA) -- host side, numpy/C++ codecs
  ops/      device kernels: prefix-doubling suffix sort, occ/rank tables,
            batched LF / backward-search, gap arrays  (jax / lax)
  engine/   orchestration: BwtOptions -> compute_bwt() -> BwtResult,
            sampled SA/ISA derivation, verification (checkbwt equivalent)
  index/    FM index structures: DNARank occ tables, wavelet trees, sampled
            SA/ISA containers, BWA export
  lcp/      succinct PLCP construction (lcpbit equivalent) + RMQ
  apps/     applications: Hamming all-mapper, k-mer probe scan, LF speed bench
  parallel/ device mesh + multi-device sharded sorting (shard_map sample sort)
  cli/      one command per reference driver program (29 tools)
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache.  ``JAX_COMPILATION_CACHE_DIR``, when
# set, names it and JAX reads it itself; otherwise the cache lives at one
# fixed path inside the checkout (the path is part of the cache key, so
# it must not move between runs).  Compiles of 1 s and longer are kept:
# the doubling sorts and walk kernels compile in seconds on a GPU, and
# shorter compiles cost less than a cache lookup.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
CACHE_MIN_COMPILE_SECS = 1.0


def _enable_jax_cache() -> None:
    """Apply the cache config, also when jax was imported before this
    package."""
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      CACHE_MIN_COMPILE_SECS)


_enable_jax_cache()
