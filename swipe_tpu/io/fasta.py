"""FASTA reading and the per-query preprocessing pipeline.

Parity target: /root/reference/query.cc:186-366 (query_init/query_read) —
multi-record FASTA from a file or stdin, characters mapped through the
symtype's alphabet with invalid characters silently dropped, reverse
complement and 6-frame translations built according to the search mode.

Search modes (symtype):
  0 blastn   nt query, nt db          3 tblastn  aa query, translated nt db
  1 blastp   aa query, aa db          4 tblastx  translated x translated
  2 blastx   translated nt query      5 sound    experimental alphabet
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Iterator, TextIO

import numpy as np

from ..alphabet import map_for_symtype, revcompl, translate, encode

__all__ = ["Query", "read_fasta", "read_queries", "QueryReader",
           "scan_fasta_bytes"]


LINE_MAX = 2048  # the reference reader's fgets buffer (swipe.h:55)


def _fgets_chunks(text: str) -> Iterator[str]:
    """The exact 'lines' the reference sees: fgets(LINE_MAX) chunks of at
    most LINE_MAX-1 chars, ending early at a newline, each truncated at
    its first NUL (query_read processes chunks with strlen/char loops,
    query.cc:274-330)."""
    pos, n = 0, len(text)
    while pos < n:
        end = text.find("\n", pos, pos + LINE_MAX - 1)
        if end >= 0:
            chunk = text[pos: end + 1]
        else:
            chunk = text[pos: pos + LINE_MAX - 1]
        pos += len(chunk)
        nul = chunk.find("\0")
        yield chunk if nul < 0 else chunk[:nul]


def read_fasta(fp: TextIO) -> Iterator[tuple[str, str]]:
    """Yield (description, raw_sequence) records from a FASTA stream.

    Reference semantics (query_read, query.cc:265-335), including the
    fgets quirks: a physical line longer than LINE_MAX-1 bytes is
    processed as several chunks — the tail of an overlong header line
    feeds the SEQUENCE char map, and a '>' landing at a chunk boundary
    of an overlong sequence line starts a new record; a chunk whose
    strlen is zero (NUL at its start) stops the reader entirely.  Text
    before the first '>' is a sequence with an empty description.
    """
    desc = None
    chunks: list[str] = []
    started = False
    for chunk in _fgets_chunks(fp.read()):
        if not chunk:
            break                  # !query_line[0]: reading ends here
        if chunk.endswith("\n"):
            chunk = chunk[:-1]
        if chunk.startswith(">"):
            if started:
                yield (desc or "", "".join(chunks))
            desc = chunk[1:]
            chunks = []
            started = True
        else:
            chunks.append(chunk)
            started = True
    if started:
        yield (desc or "", "".join(chunks))


def scan_fasta_bytes(blob: bytes):
    """Vectorized whole-file FASTA scan — the database-ingestion fast path.

    The reference reads its FASTA database record by record through the
    same fgets loop as queries; at Swiss-Prot scale a per-record Python
    loop costs ~14 s, so bulk ingestion scans the whole byte stream with
    numpy instead (the array-idiomatic replacement for the reference's
    pthread-parallel db preprocessing, /root/reference/swipe.cc:804,
    1684-1699).

    Returns ``(headers, seq_bytes, counts)``: per-record descriptions,
    the uint8 concatenation of every sequence-line's bytes, and each
    record's byte count within it — element-for-element what read_fasta
    yields as ``(desc, "".join(lines))``.  Returns ``None`` when the
    stream needs the exact fgets reader instead: a NUL byte (fgets
    truncation), a physical line at the fgets chunk size, or any
    non-ASCII byte (text-mode decode differences).
    """
    data = np.frombuffer(blob, dtype=np.uint8)
    n = data.size
    if n == 0:
        return [], data, np.zeros(0, dtype=np.int64)
    if int(data.max()) >= 128 or not int(data.min()):
        return None
    NL = 0x0A
    nl_idx = np.flatnonzero(data == NL)
    line_starts = np.concatenate([[0], nl_idx + 1])
    if line_starts[-1] == n:                 # file ends with the newline
        line_starts = line_starts[:-1]
    nlines = line_starts.size
    line_ends = np.empty(nlines, dtype=np.int64)
    line_ends[: nl_idx.size] = nl_idx[:nlines]
    if nlines > nl_idx.size:
        line_ends[-1] = n                    # final line, no newline
    lengths = line_ends - line_starts
    is_hdr = data[line_starts] == ord(">")
    if int(lengths.max()) >= LINE_MAX - 1:
        # fgets splits these lines into LINE_MAX-1 chunks.  For sequence
        # lines the record still sees the same bytes joined — UNLESS a
        # chunk boundary lands on a '>' (that starts a new record); a
        # header line that spills real characters into a second chunk
        # (content >= LINE_MAX) feeds them to the SEQUENCE map.  Both
        # need the exact reader; plain unwrapped FASTA does not.
        if int(lengths[is_hdr].max(initial=0)) >= LINE_MAX:
            return None
        ov = (lengths >= LINE_MAX - 1) & ~is_hdr
        s_ov, e_ov = line_starts[ov], line_ends[ov]
        k = 1
        while True:
            pos = s_ov + k * (LINE_MAX - 1)
            m = pos < e_ov
            if not m.any():
                break
            if (data[pos[m]] == ord(">")).any():
                return None
            k += 1
    has_preamble = bool(nlines) and not bool(is_hdr[0])
    headers = [""] * has_preamble + [
        blob[s + 1: e].decode("ascii")
        for s, e in zip(line_starts[is_hdr], line_ends[is_hdr])]
    # content mask: every byte of every non-header line (newlines and
    # header lines excluded).  Header ranges are cleared with a Python
    # loop over the (few, short) header lines — byte-level cumsum masks
    # measured 10-50x slower on this path (whole-file-sized temporaries;
    # the box is memory-bandwidth-bound).
    content = data != NL
    for s, e in zip(line_starts[is_hdr], line_ends[is_hdr]):
        content[s:e] = False
    seq_bytes = data[content]
    # per-record byte counts from the per-LINE length table (about 200x
    # fewer elements than the byte stream; byte-level reduceat/cumsum
    # both measured in the tens of seconds here): zero the header lines'
    # lengths, then sum line runs per record.  No segment is empty (a
    # header line is >= 1 byte and a preamble only exists when it has a
    # line), so reduceat's repeated-index quirk cannot trigger.
    rec_first_line = np.flatnonzero(is_hdr)
    if has_preamble:
        rec_first_line = np.concatenate([[0], rec_first_line])
    seq_lens = np.where(is_hdr, 0, lengths)
    counts = np.add.reduceat(seq_lens, rec_first_line) \
        if rec_first_line.size else np.zeros(0, dtype=np.int64)
    return headers, seq_bytes, counts


@dataclass
class Query:
    """One preprocessed query: encoded sequence(s) for every strand/frame."""

    description: str
    symtype: int
    strands: int  # bit 1 = plus, bit 2 = minus
    nt: list[np.ndarray | None] = field(default_factory=lambda: [None, None])
    # aa[3*strand + frame] for translated modes; aa[0] for protein modes
    aa: list[np.ndarray | None] = field(default_factory=lambda: [None] * 6)

    @property
    def length(self) -> int:
        """Length of the primary query sequence (nt for nt modes, else aa)."""
        if self.symtype in (0, 2, 4):
            return 0 if self.nt[0] is None else len(self.nt[0])
        return 0 if self.aa[0] is None else len(self.aa[0])

    def frames(self) -> list[tuple[int, int, np.ndarray]]:
        """All (strand, frame, encoded_seq) the search phase must score."""
        out = []
        if self.symtype in (2, 4):
            for s in range(2):
                if (s + 1) & self.strands:
                    for f in range(3):
                        seq = self.aa[3 * s + f]
                        if seq is not None:
                            out.append((s, f, seq))
        elif self.symtype == 0:
            for s in range(2):
                if (s + 1) & self.strands and self.nt[s] is not None:
                    out.append((s, 0, self.nt[s]))
        else:
            if self.aa[0] is not None:
                out.append((0, 0, self.aa[0]))
        return out


def preprocess_query(description: str, raw: str, symtype: int, strands: int,
                     query_gencode: int = 1) -> Query:
    """Encode a raw query and build strand/frame variants per search mode."""
    charmap = map_for_symtype(symtype)
    seq = encode(raw, charmap)

    q = Query(description, symtype, strands)
    if symtype in (0, 2, 4):
        q.nt[0] = seq
        if strands & 2:
            q.nt[1] = revcompl(seq)
        if symtype in (2, 4):
            for s in range(2):
                if (s + 1) & strands:
                    for f in range(3):
                        q.aa[3 * s + f] = translate(seq, s, f, query_gencode)
    else:
        q.aa[0] = seq
    return q


def read_queries(path: str, symtype: int, strands: int,
                 query_gencode: int = 1) -> Iterator[Query]:
    """Read and preprocess every query in a FASTA file ('-' = stdin).

    Files are read byte-exact (latin-1): the reference consumes raw bytes
    and the char maps drop anything unmappable (query.cc:265-330), so a
    stray non-UTF-8 byte in a header must not abort the run.  The file is
    opened eagerly so a missing path fails at call time like the
    reference's query_init fatal (query.cc:194).
    """
    import io as _io
    if path == "-":
        fp = _io.TextIOWrapper(sys.stdin.buffer, encoding="latin-1")
    else:
        try:
            fp = open(path, encoding="latin-1")
        except IsADirectoryError:
            # C fopen succeeds on a directory and fgets then fails:
            # the reference reads it as an empty query file
            fp = _io.StringIO("")

    def gen():
        try:
            for desc, raw in read_fasta(fp):
                yield preprocess_query(desc, raw, symtype, strands,
                                       query_gencode)
        finally:
            if path != "-":
                fp.close()
    return gen()


class QueryReader:
    """Stateful reader mirroring the reference's query_init/query_read API."""

    def __init__(self, path: str, symtype: int, strands: int,
                 query_gencode: int = 1):
        self._it = read_queries(path, symtype, strands, query_gencode)

    def __iter__(self) -> Iterator[Query]:
        return self._it
