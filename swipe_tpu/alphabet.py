"""Alphabets, character maps, reverse complement and genetic-code translation.

Rebuild of the sequence-symbol layer of SWIPE.  All alphabets follow
the NCBI conventions (parity target: /root/reference/query.cc:31-179,368-506):

* ``ncbi_aa``  : 28-symbol protein alphabet, codes 0..27, ``sym_ncbi_aa``.
* ``ncbi_nt16``: 16-symbol IUPAC nucleotide alphabet (bitmask of ACGT), used for
  queries and uncompressed db sequences.
* ``ncbi_nt4`` : 2-bit nucleotide alphabet used inside BLAST db files.
* ``sound``    : 31-symbol experimental alphabet (symtype 5).

Everything here is pure host-side NumPy: these tables are built once per
process and then baked into device-side constant tensors by the kernels.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "SYM_NCBI_AA",
    "SYM_NCBI_NT16",
    "SYM_NCBI_NT16U",
    "SYM_NCBI_NT4",
    "SYM_SOUND",
    "MAP_NCBI_AA",
    "MAP_NCBI_NT16",
    "MAP_NCBI_NT4",
    "MAP_SOUND",
    "NT_COMPL",
    "GENCODE_NAMES",
    "GENETIC_CODES",
    "encode",
    "decode",
    "revcompl",
    "translation_table",
    "translate",
    "map_for_symtype",
    "sym_for_symtype",
]

# Symbol tables (index -> display character).  '#' marks unused codes.
SYM_NCBI_NT4 = "acgt############################"
SYM_NCBI_NT16 = "-acmgrsvtwyhkdbn################"
SYM_NCBI_NT16U = "-ACMGRSVTWYHKDBN################"
SYM_NCBI_AA = "-ABCDEFGHIKLMNPQRSTVWXYZU*OJ####"
SYM_SOUND = "-ABCDEFGHIJKLMNOPQRSTUVWXYZabcde"


def _build_map(pairs: dict[str, int], fold_case: bool = True) -> np.ndarray:
    """256-entry char -> code map; -1 for characters outside the alphabet."""
    m = np.full(256, -1, dtype=np.int8)
    for ch, code in pairs.items():
        m[ord(ch)] = code
        if fold_case and ch.isalpha():
            m[ord(ch.swapcase())] = code
    return m


# Protein: A..Z plus '-' and '*'; J->27, O->26, U->24, X->21, '*'->25.
MAP_NCBI_AA = _build_map(
    {
        "-": 0, "A": 1, "B": 2, "C": 3, "D": 4, "E": 5, "F": 6, "G": 7,
        "H": 8, "I": 9, "K": 10, "L": 11, "M": 12, "N": 13, "P": 14,
        "Q": 15, "R": 16, "S": 17, "T": 18, "V": 19, "W": 20, "X": 21,
        "Y": 22, "Z": 23, "U": 24, "*": 25, "O": 26, "J": 27,
    }
)

# IUPAC nucleotides as ACGT bitmasks: A=1 C=2 G=4 T=8, ambiguity codes are ORs.
MAP_NCBI_NT16 = _build_map(
    {
        "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6, "V": 7,
        "T": 8, "U": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13,
        "B": 14, "N": 15,
    }
)

MAP_NCBI_NT4 = _build_map({"A": 0, "C": 1, "G": 2, "T": 3, "U": 3})

# Sound alphabet (symtype 5): uppercase A-Z -> 1..26, a-e -> 27..31.
_sound_pairs: dict[str, int] = {chr(ord("A") + i): 1 + i for i in range(26)}
_sound_pairs.update({chr(ord("a") + i): 27 + i for i in range(5)})
MAP_SOUND = _build_map(_sound_pairs, fold_case=False)

# Complement of an nt16 bitmask: swap A<->T bits and C<->G bits.
NT_COMPL = np.array(
    [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15], dtype=np.int8
)

GENCODE_NAMES: dict[int, str] = {
    1: "Standard Code",
    2: "Vertebrate Mitochondrial Code",
    3: "Yeast Mitochondrial Code",
    4: "Mold, Protozoan, and Coelenterate Mitochondrial Code and "
       "Mycoplasma/Spiroplasma Code",
    5: "Invertebrate Mitochondrial Code",
    6: "Ciliate, Dasycladacean and Hexamita Nuclear Code",
    9: "Echinoderm and Flatworm Mitochondrial Code",
    10: "Euplotid Nuclear Code",
    11: "Bacterial, Archaeal and Plant Plastid Code",
    12: "Alternative Yeast Nuclear Code",
    13: "Ascidian Mitochondrial Code",
    14: "Alternative Flatworm Mitochondrial Code",
    15: "Blepharisma Nuclear Code",
    16: "Chlorophycean Mitochondrial Code",
    21: "Trematode Mitochondrial Code",
    22: "Scenedesmus obliquus Mitochondrial Code",
    23: "Thraustochytrium Mitochondrial Code",
}

# NCBI genetic code tables: 64 amino acids indexed by codon TCAG-order
# (index = 16*b1 + 4*b2 + b3 with T=0, C=1, A=2, G=3).
GENETIC_CODES: dict[int, str] = {
    1:  "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    2:  "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
    3:  "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4:  "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    5:  "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
    6:  "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    9:  "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    10: "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    11: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    12: "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    13: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
    14: "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    15: "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    16: "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    21: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    22: "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    23: "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}

# nt16 single-base bit index -> codon-table base index.  nt16 bit i (1<<i)
# corresponds to bases A,C,G,T for i=0..3; the code strings above are in
# T,C,A,G order, so A->2, C->1, G->3, T->0.
_NT16_BIT_TO_TCAG = np.array([2, 1, 3, 0], dtype=np.int64)


def map_for_symtype(symtype: int) -> np.ndarray:
    """Char->code map used for *query* characters of the given symtype."""
    if symtype == 5:
        return MAP_SOUND
    if symtype in (1, 3):
        return MAP_NCBI_AA
    return MAP_NCBI_NT16


def sym_for_symtype(symtype: int) -> str:
    if symtype == 5:
        return SYM_SOUND
    if symtype in (1, 3):
        return SYM_NCBI_AA
    return SYM_NCBI_NT16


def encode(text: str | bytes, charmap: np.ndarray) -> np.ndarray:
    """Map raw characters through a 256-entry map, dropping invalid ones."""
    if isinstance(text, str):
        text = text.encode("ascii", errors="replace")
    raw = np.frombuffer(text, dtype=np.uint8)
    codes = charmap[raw]
    return codes[codes >= 0].astype(np.int8)


def decode(codes: np.ndarray, symbols: str) -> str:
    sym = np.frombuffer(symbols.encode(), dtype=np.uint8)
    return bytes(sym[np.asarray(codes, dtype=np.int64)]).decode()


def revcompl(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of an nt16-encoded sequence."""
    return NT_COMPL[np.asarray(seq, dtype=np.int64)][::-1].astype(np.int8)


@functools.lru_cache(maxsize=None)
def translation_table(gencode: int) -> np.ndarray:
    """16x16x16 nt16-codon -> aa-code table with ambiguity inference.

    For an ambiguous codon the translated symbol is the unique amino acid if
    all concrete codons agree, B/Z when they only span {D,N}/{Q,E}, else X.
    Codons containing a gap (nt16 code 0) translate to X as well.
    Parity target: translate_createtable (/root/reference/query.cc:377-451).
    """
    code = GENETIC_CODES[gencode]
    table = np.zeros(16 * 16 * 16, dtype=np.int8)
    x_code = MAP_NCBI_AA[ord("X")]
    aa_of_codon = [code[i] for i in range(64)]

    for a in range(16):
        for b in range(16):
            for c in range(16):
                aa = None
                for i in range(4):
                    if not (a & (1 << i)):
                        continue
                    for j in range(4):
                        if not (b & (1 << j)):
                            continue
                        for k in range(4):
                            if not (c & (1 << k)):
                                continue
                            codon = (
                                _NT16_BIT_TO_TCAG[i] * 16
                                + _NT16_BIT_TO_TCAG[j] * 4
                                + _NT16_BIT_TO_TCAG[k]
                            )
                            x = aa_of_codon[codon]
                            if aa is None or aa == x:
                                aa = x if aa is None else aa
                            elif aa == "B" and x in ("D", "N"):
                                pass
                            elif aa == "D" and x in ("B", "N"):
                                aa = "B"
                            elif aa == "N" and x in ("B", "D"):
                                aa = "B"
                            elif aa == "Z" and x in ("Q", "E"):
                                pass
                            elif aa == "E" and x in ("Z", "Q"):
                                aa = "Z"
                            elif aa == "Q" and x in ("Z", "E"):
                                aa = "Z"
                            else:
                                aa = "X"
                table[256 * a + 16 * b + c] = (
                    x_code if aa is None else MAP_NCBI_AA[ord(aa)]
                )
    return table


def translate(
    dna: np.ndarray, strand: int, frame: int, gencode: int
) -> np.ndarray:
    """Translate one reading frame of an nt16 sequence to aa codes.

    ``strand`` 0 = forward, 1 = reverse complement; ``frame`` in 0..2.
    Parity target: translate() (/root/reference/query.cc:459-506).
    """
    dna = np.asarray(dna, dtype=np.int64)
    dlen = len(dna)
    plen = (dlen - frame) // 3
    if plen <= 0:
        return np.zeros(0, dtype=np.int8)
    if strand == 0:
        codons = dna[frame : frame + 3 * plen].reshape(plen, 3)
    else:
        rc = revcompl(dna).astype(np.int64)
        codons = rc[frame : frame + 3 * plen].reshape(plen, 3)
    idx = (codons[:, 0] << 8) | (codons[:, 1] << 4) | codons[:, 2]
    return translation_table(gencode)[idx].astype(np.int8)
