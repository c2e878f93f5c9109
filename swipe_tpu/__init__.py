"""swipe-tpu: a Smith-Waterman database-search engine in JAX.

A from-scratch JAX rebuild of the capabilities of SWIPE
(Rognes 2011, https://github.com/torognes/swipe): exhaustive optimal
local-alignment search of protein/nucleotide queries against large sequence
databases, with BLAST-compatible statistics, formats and search modes
(blastn/blastp/blastx/tblastn/tblastx).

Architecture:
  * the inter-sequence SIMD DP of SWIPE's search7/16/63 kernels becomes a
    lane stream: thousands of database sequences concatenated per lane,
    scored on an NVIDIA GPU by a CUDA kernel (native/sw_stream.cu, one
    warp or sub-warp per (query, lane) pair, query rows in registers,
    Hopper's DPX add-max instructions) and elsewhere by its lax.scan twin;
  * the per-lane refill machine becomes host-side LPT lane packing with a
    streamed start mask (static shapes for XLA);
  * the pthreads work queue + MPI master/slave become shard_map over a
    device mesh with lax.top_k merges and psum counters;
  * the 7->16->63-bit precision escalation becomes a single exact int32
    pass; the cascade's counters are derived from the exact scores.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy public API (keeps bare import light; jax loads on first use)."""
    if name in ("SearchEngine", "SearchParams", "SearchTimings"):
        from . import pipeline
        return getattr(pipeline, name)
    if name in ("FastaDatabase",):
        from .io.db import FastaDatabase
        return FastaDatabase
    if name in ("BlastDatabase",):
        from .io.blastdb import BlastDatabase
        return BlastDatabase
    if name in ("read_queries", "preprocess_query"):
        from .io import fasta
        return getattr(fasta, name)
    if name in ("ScoreMatrix",):
        from .matrices import ScoreMatrix
        return ScoreMatrix
    raise AttributeError(name)
