"""Swiss-Prot-realistic benchmark corpus generator.

BASELINE.md's measurement configs name Swiss-Prot explicitly; synthetic
uniform/lognormal toy corpora have a slightly different length tail and a
flat residue composition, both of which shift lane occupancy and dprofile
statistics.  This module generates sequences fitted to the PUBLISHED
UniProtKB/Swiss-Prot statistics so the benches run on the real
distribution shape without checking in a 250 MB database:

* residue composition: the 20-entry amino-acid frequency table from the
  UniProtKB/Swiss-Prot release statistics (Leu 9.66% ... Trp 1.08%);
* lengths: log-normal fitted to the published median (~292 aa) and mean
  (~361 aa): mu = ln 292 = 5.677, sigma = sqrt(2 ln(361/292)) = 0.651,
  clipped to [2, 35213] (35213 = titin, the longest Swiss-Prot entry);
* DNA configs use uniform ACGT at the requested lengths (config 3's DNA
  DB has no canonical composition target).

Sequences are emitted as NCBIstdaa codes (swipe_tpu.alphabet.MAP_NCBI_AA)
ready for the kernels.
"""

from __future__ import annotations

import numpy as np

from swipe_tpu.alphabet import MAP_NCBI_AA

# UniProtKB/Swiss-Prot amino-acid composition (release statistics), %.
SWISSPROT_AA_PERCENT = {
    "A": 8.25, "R": 5.53, "N": 4.06, "D": 5.45, "C": 1.38,
    "Q": 3.93, "E": 6.75, "G": 7.07, "H": 2.27, "I": 5.96,
    "L": 9.66, "K": 5.84, "M": 2.42, "F": 3.86, "P": 4.70,
    "S": 6.56, "T": 5.34, "W": 1.08, "Y": 2.92, "V": 6.87,
}

# log-normal length fit (median 292, mean 361), clipped to Swiss-Prot's
# observed extremes
LEN_MU = 5.677
LEN_SIGMA = 0.651
LEN_MIN, LEN_MAX = 2, 35213

_codes = np.array([MAP_NCBI_AA[ord(a)] for a in SWISSPROT_AA_PERCENT],
                  dtype=np.int8)
_freqs = np.array(list(SWISSPROT_AA_PERCENT.values()), dtype=np.float64)
_freqs /= _freqs.sum()


def swissprot_lengths(n: int, rng: np.random.Generator) -> np.ndarray:
    """[n] int64 sequence lengths from the fitted Swiss-Prot model."""
    return np.clip(rng.lognormal(LEN_MU, LEN_SIGMA, n).astype(np.int64),
                   LEN_MIN, LEN_MAX)


def swissprot_seqs(n: int, rng: np.random.Generator,
                   lengths: np.ndarray | None = None) -> list[np.ndarray]:
    """n protein sequences (NCBIstdaa codes) with Swiss-Prot composition."""
    if lengths is None:
        lengths = swissprot_lengths(n, rng)
    return [rng.choice(_codes, size=int(L), p=_freqs) for L in lengths]


def swissprot_query(qlen: int, rng: np.random.Generator) -> np.ndarray:
    """One protein query of the requested length, Swiss-Prot composition."""
    return rng.choice(_codes, size=int(qlen), p=_freqs)


_letters = np.array(list(SWISSPROT_AA_PERCENT), dtype="U1")


def swissprot_letters(length: int, rng: np.random.Generator) -> str:
    """Residue letters (for FASTA text), Swiss-Prot composition."""
    return "".join(rng.choice(_letters, size=int(length), p=_freqs))


def swissprot_fasta(n: int, rng: np.random.Generator,
                    max_len: int | None = None) -> str:
    """FASTA text of n Swiss-Prot-like protein sequences (composition AND
    length model; ``max_len`` optionally trims the titin-scale tail for
    memory-bounded configs)."""
    lens = swissprot_lengths(n, rng)
    if max_len is not None:
        lens = np.minimum(lens, max_len)
    return "".join(
        f">s{i} seq {i}\n{swissprot_letters(L, rng)}\n"
        for i, L in enumerate(lens))


def write_swissprot_fasta(path: str, n: int, rng: np.random.Generator,
                          max_len: int | None = None) -> int:
    """Write n Swiss-Prot-like protein sequences (the same composition
    and length model as swissprot_fasta) to a FASTA file, drawing all
    residues in one call so a Swiss-Prot-scale database (570k sequences,
    ~2e8 residues) takes seconds.  Returns the residue count."""
    lens = swissprot_lengths(n, rng)
    if max_len is not None:
        lens = np.minimum(lens, max_len)
    letters = np.frombuffer("".join(SWISSPROT_AA_PERCENT).encode(),
                            dtype=np.uint8)
    res = letters[rng.choice(len(letters), size=int(lens.sum()), p=_freqs)]
    ends = np.cumsum(lens)
    with open(path, "wb") as f:
        lo = 0
        for i, hi in enumerate(ends):
            f.write(b">s%d seq %d\n" % (i, i))
            f.write(res[lo:hi].tobytes())
            f.write(b"\n")
            lo = hi
    return int(lens.sum())
