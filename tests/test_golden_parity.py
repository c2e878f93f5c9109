"""Golden parity: byte-compare our output with the reference SWIPE binary.

The reference sources are mounted at /root/reference; they are copied to a
temp dir and compiled once per session (x86 with SSE2 required).  Databases
are produced by our own BLAST v4 writer — which doubles as a writer test,
since the reference binary must parse them.

Volatile lines (program banner, compile stamp, timestamps, speed) are
stripped before comparison; everything else must match byte for byte.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from swipe_tpu.alphabet import MAP_NCBI_AA, MAP_NCBI_NT16, encode
from swipe_tpu.io.blastdb_writer import make_deflines, write_blastdb

REF_SRC = "/root/reference"
REF_BIN_DIR = "/tmp/swipe_tpu_refbuild"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_SRC), reason="reference sources not available")


@pytest.fixture(scope="session")
def ref_swipe():
    binpath = os.path.join(REF_BIN_DIR, "swipe")
    if not os.path.exists(binpath):
        shutil.copytree(REF_SRC, REF_BIN_DIR, dirs_exist_ok=True)
        r = subprocess.run(["make", "-j4", "swipe"], cwd=REF_BIN_DIR,
                           capture_output=True)
        if r.returncode != 0:
            pytest.skip("cannot build reference binary: "
                        + r.stderr.decode()[-500:])
    return binpath


VOLATILE = re.compile(
    r"^(SWIPE|swipe-tpu|Search started|Search completed|Elapsed|Speed|"
    r"# SWIPE|Database time|\s*<programVersion>|\s*<searchStarted>|"
    r"\s*<searchCompleted>|\s*<searchElapsedTime>|\s*<searchSpeed>|"
    r"\s*<queryFilename>|\s*<databaseFilename>|\s*<databaseDate>|"
    r"\s*<threads>)")


def _normalize(text: str) -> str:
    return "\n".join(l for l in text.splitlines() if not VOLATILE.match(l))


def run_ref(ref_bin, args):
    r = subprocess.run([ref_bin] + args, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    return r.stdout.decode()


def run_ours(args, backend="lax"):
    import io
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(args + ["--backend", backend])
    assert rc == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One small protein and one small nucleotide golden database."""
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("golden")
    AA = list("ARNDCQEGHILKMFPSTWYV")
    NT = list("ACGT")

    qp = "".join(rng.choice(AA, 70))
    paa = []
    pdesc = []
    for i in range(25):
        s = "".join(rng.choice(AA, int(rng.integers(30, 120))))
        if i == 4:
            s = qp[5:60]
        if i == 11:
            s = s[:20] + qp[10:45] + s[20:]
        paa.append(encode(s, MAP_NCBI_AA))
        pdesc.append(f"pseq{i} protein test sequence {i}")
    write_blastdb(str(d / "prot"), paa, make_deflines(pdesc), "aa",
                  title="golden protein db", date="Jan 1, 2026  12:00 AM")

    qn = "".join(rng.choice(NT, 80))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(qn))
    nnt = []
    ndesc = []
    for i in range(20):
        s = "".join(rng.choice(NT, int(rng.integers(40, 160))))
        if i == 2:
            s = qn
        if i == 7:
            s = rc + "NRYW"
        if i == 12:
            s = s[:30] + "N" * 6 + s[30:]
        nnt.append(encode(s, MAP_NCBI_NT16))
        ndesc.append(f"nseq{i} nucleotide test sequence {i}")
    write_blastdb(str(d / "nucl"), nnt, make_deflines(ndesc), "nt",
                  title="golden nt db", date="Jan 1, 2026  12:00 AM")

    (d / "qp.fa").write_text(f">qprot test protein query\n{qp}\n")
    (d / "qn.fa").write_text(f">qnucl test nt query\n{qn}\n")
    return d


def test_golden_gi_deflines(ref_swipe, tmp_path):
    """gi-bearing (and multi-defline) headers: the reference forces
    show_gis=1 for -m 8/9 and -m 99 regardless of -I, and carries a
    previous defline's gi into gi-less later deflines (-m 99)."""
    from swipe_tpu.io.asn1 import Defline, SeqId
    rng = np.random.default_rng(88)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    qp = "".join(rng.choice(AAl, 55))
    seqs, dls = [], []
    for i in range(12):
        s = "".join(rng.choice(AAl, int(rng.integers(30, 90))))
        if i in (3, 5):
            s = qp[4:50]
        seqs.append(encode(s, MAP_NCBI_AA))
        ids = [SeqId("gi", number=1000 + i),
               SeqId("sp", accession=f"P{i:05d}", version=1,
                     name=f"NAM{i}_HUMAN")]
        d = [Defline(title=f"gi seq {i}", seqids=ids)]
        if i == 3:
            # second defline WITHOUT a gi: -m 99 must reuse defline 1's gi
            d.append(Defline(title=f"alt name {i}",
                             seqids=[SeqId("sp", accession="Q99999",
                                           version=2, name="ALT_HUMAN")]))
        dls.append(d)
    write_blastdb(str(tmp_path / "gidb"), seqs, dls, "aa",
                  title="gi golden db", date="Jan 1, 2026  12:00 AM")
    (tmp_path / "q.fa").write_text(f">q gi query\n{qp}\n")
    base = ["-d", str(tmp_path / "gidb"), "-i", str(tmp_path / "q.fa"),
            "-p", "blastp"]
    for extra in (["-m", "8"], ["-m", "9", "-I"], ["-m", "99"],
                  ["-m", "99", "-I"], ["-m", "0"], ["-m", "7"],
                  ["-m", "7", "-I"]):
        args = base + extra
        ref_out = _normalize(run_ref(ref_swipe, args))
        our_out = _normalize(run_ours(args))
        assert our_out == ref_out, (
            f"gi defline mismatch for {extra}\n"
            + "\n".join(_first_diff(ref_out, our_out)))


def test_golden_masked_subset(ref_swipe, tmp_path):
    """Masked-subset db (.msk OID bitmap + MEMB_BIT): both programs agree."""
    import struct

    from swipe_tpu.io.asn1 import Defline
    rng = np.random.default_rng(55)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    qp = "".join(rng.choice(AAl, 50))
    n = 16
    seqs, dls = [], []
    for i in range(n):
        s = "".join(rng.choice(AAl, int(rng.integers(30, 90))))
        if i == 6:
            s = qp[2:45]
        if i == 7:
            s = qp[5:48]   # in base but NOT in the subset (odd oid)
        seqs.append(encode(s, MAP_NCBI_AA))
        dls.append([Defline(title=f"mk{i} masked golden {i}",
                            memberships=1 if i % 2 == 0 else 0)])
    write_blastdb(str(tmp_path / "base"), seqs, dls, "aa",
                  title="masked base", date="Jan 1, 2026  12:00 AM")
    bits = bytearray((n + 7) // 8)
    nres = 0
    for i in range(n):
        if i % 2 == 0:
            bits[i // 8] |= 1 << (7 - (i % 8))
            nres += len(seqs[i])
    (tmp_path / "sub.msk").write_bytes(
        struct.pack(">I", n) + bytes(bits))
    (tmp_path / "inner.pal").write_text(
        "TITLE  masked inner\nDBLIST base\nOIDLIST sub.msk\n"
        "LENGTH %d\nNSEQ %d\nMAXOID %d\nMEMB_BIT 1\n"
        % (nres, n // 2, n - 1))
    (tmp_path / "sub.pal").write_text(
        "TITLE  masked subset golden\nDBLIST inner\nMEMB_BIT 1\n")
    (tmp_path / "q.fa").write_text(f">q masked query\n{qp}\n")
    args = ["-p", "blastp", "-m", "9",
            "-d", str(tmp_path / "sub"), "-i", str(tmp_path / "q.fa")]
    ref_out = _normalize(run_ref(ref_swipe, args))
    our_out = _normalize(run_ours(args))
    assert "mk6" in our_out and "mk7" not in our_out
    assert our_out == ref_out


def test_golden_taxid_filter(ref_swipe, tmp_path):
    """-x taxid list: both programs include the same subset."""
    rng = np.random.default_rng(66)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    qp = "".join(rng.choice(AAl, 40))
    n = 10
    seqs, descs, taxids = [], [], []
    for i in range(n):
        s = "".join(rng.choice(AAl, int(rng.integers(25, 70))))
        if i in (2, 3):
            s = qp[1:35]
        seqs.append(encode(s, MAP_NCBI_AA))
        descs.append(f"tx{i} taxid golden {i}")
        taxids.append(100 + i)
    write_blastdb(str(tmp_path / "txdb"), seqs,
                  make_deflines(descs, taxids=taxids), "aa",
                  title="taxid golden db", date="Jan 1, 2026  12:00 AM")
    (tmp_path / "tx.txt").write_text("102\n105\n107\n")
    (tmp_path / "q.fa").write_text(f">q taxid query\n{qp}\n")
    args = ["-p", "blastp", "-m", "9", "-e", "1000",
            "-d", str(tmp_path / "txdb"), "-i", str(tmp_path / "q.fa"),
            "-x", str(tmp_path / "tx.txt")]
    ref_out = _normalize(run_ref(ref_swipe, args))
    our_out = _normalize(run_ours(args))
    assert "tx2" in our_out and "tx3" not in our_out
    assert our_out == ref_out


def test_golden_multivolume(ref_swipe, dbs, tmp_path):
    """Both programs read the same two-volume alias db identically."""
    rng = np.random.default_rng(77)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    qp = "".join(rng.choice(AAl, 60))
    vols = []
    for v in range(2):
        seqs, descs = [], []
        for i in range(12):
            s = "".join(rng.choice(AAl, int(rng.integers(30, 100))))
            if v == 0 and i == 5:
                s = qp[5:55]
            seqs.append(encode(s, MAP_NCBI_AA))
            descs.append(f"v{v}s{i} volume {v} seq {i}")
        write_blastdb(str(tmp_path / f"vol{v}"), seqs,
                      make_deflines(descs), "aa",
                      title=f"vol {v}", date="Jan 1, 2026  12:00 AM")
        vols.append(f"vol{v}")
    (tmp_path / "multi.pal").write_text(
        "TITLE  combined golden db\nDBLIST %s\n" % " ".join(vols))
    (tmp_path / "q.fa").write_text(f">q multi query\n{qp}\n")
    args = ["-p", "blastp", "-m", "9",
            "-d", str(tmp_path / "multi"), "-i", str(tmp_path / "q.fa")]
    assert _normalize(run_ours(args)) == _normalize(run_ref(ref_swipe, args))


CASES = [
    ("blastp-m8", ["-p", "blastp", "-m", "8"], "prot", "qp.fa"),
    ("blastp-m9", ["-p", "blastp", "-m", "9"], "prot", "qp.fa"),
    ("blastp-m0", ["-p", "blastp", "-m", "0"], "prot", "qp.fa"),
    ("blastp-m7", ["-p", "blastp", "-m", "7"], "prot", "qp.fa"),
    ("blastn-m8", ["-p", "blastn", "-m", "8"], "nucl", "qn.fa"),
    ("blastn-m0", ["-p", "blastn", "-m", "0"], "nucl", "qn.fa"),
    ("blastx-m9", ["-p", "blastx", "-m", "9"], "prot", "qn.fa"),
    ("blastx-m0", ["-p", "blastx", "-m", "0"], "prot", "qn.fa"),
    ("tblastn-m9", ["-p", "tblastn", "-m", "9"], "nucl", "qp.fa"),
    ("tblastn-m0", ["-p", "tblastn", "-m", "0"], "nucl", "qp.fa"),
    ("tblastx-m9", ["-p", "tblastx", "-m", "9"], "nucl", "qn.fa"),
    ("blastp-minexp", ["-p", "blastp", "-m", "9", "-k", "0.001"],
     "prot", "qp.fa"),
    ("blastp-evalue", ["-p", "blastp", "-m", "8", "-e", "0.1"],
     "prot", "qp.fa"),
    ("blastp-b2v5", ["-p", "blastp", "-m", "0", "-b", "2", "-v", "5"],
     "prot", "qp.fa"),
    ("blastn-strandminus", ["-p", "blastn", "-m", "0", "-S", "2",
                            "-e", "100"], "nucl", "qn.fa"),
    ("blastn-strandplus", ["-p", "blastn", "-m", "8", "-S", "1"],
     "nucl", "qn.fa"),
    ("blastp-m99", ["-p", "blastp", "-m", "99"], "prot", "qp.fa"),
    ("blastp-gis", ["-p", "blastp", "-m", "9", "-I"], "prot", "qp.fa"),
    ("dump-prot", ["-p", "blastp", "-N", "1"], "prot", "qp.fa"),
    ("dump-nucl", ["-p", "blastn", "-N", "1"], "nucl", "qn.fa"),
    ("blastx-m99", ["-p", "blastx", "-m", "99"], "prot", "qn.fa"),
    ("blastp-pam30", ["-p", "blastp", "-m", "9", "-M", "PAM30"],
     "prot", "qp.fa"),
    # explicit -u upper score cutoff: hits above it are counted as
    # "obvious" but excluded (hits.cc:168-180); the stream backend masks
    # them inside the device top-K reduction
    ("blastp-upper", ["-p", "blastp", "-m", "9", "-u", "40"],
     "prot", "qp.fa"),
    # blastn reward/penalty pair off the default (+1/-3): synthesized nt
    # matrix + its KA table row
    ("blastn-rq", ["-p", "blastn", "-m", "9", "-r", "2", "-q", "-3"],
     "nucl", "qn.fa"),
]


@pytest.mark.parametrize("name,args,db,qf", CASES, ids=[c[0] for c in CASES])
def test_golden(ref_swipe, dbs, name, args, db, qf):
    full = args + ["-d", str(dbs / db), "-i", str(dbs / qf)]
    ref_out = _normalize(run_ref(ref_swipe, full))
    our_out = _normalize(run_ours(full))
    assert our_out == ref_out, (
        f"output mismatch for {name}\n--- first diff ---\n"
        + "\n".join(_first_diff(ref_out, our_out)))


# production-path parity: the same byte comparison, but through the
# stream backend (pack_stream grouping, the platform's stream kernel —
# the lax twin on the CPU — and the device-side top-K reduction) — so
# the CLI -> stream -> top-K -> report chain sits in the byte-parity
# loop, not only the segment route.  A subset of CASES covering every mode/view plus the upper
# cutoff, where the device reduction masks scores.
STREAM_CASES = [
    "blastp-m8", "blastp-m0", "blastp-m7", "blastp-m99",
    "blastn-m8", "blastn-m0", "blastx-m9", "blastx-m0",
    "tblastn-m9", "tblastx-m9", "blastp-minexp", "blastp-evalue",
    "blastn-strandminus", "blastp-b2v5", "blastp-upper", "blastn-rq",
]


@pytest.mark.parametrize(
    "name,args,db,qf",
    [c for c in CASES if c[0] in STREAM_CASES],
    ids=[c[0] for c in CASES if c[0] in STREAM_CASES])
def test_golden_stream_backend(ref_swipe, dbs, name, args, db, qf):
    full = args + ["-d", str(dbs / db), "-i", str(dbs / qf)]
    ref_out = _normalize(run_ref(ref_swipe, full))
    our_out = _normalize(run_ours(full, backend="stream"))
    assert our_out == ref_out, (
        f"stream-backend mismatch for {name}\n--- first diff ---\n"
        + "\n".join(_first_diff(ref_out, our_out)))


def test_golden_cli_quirks(ref_swipe, dbs):
    """C-flavored CLI corners: atol/atof suffixed numeric arguments,
    getopt's silently-ignored positional arguments, and an empty query
    record (Kmn = 0 — the reference's (long)ceil(-inf) threshold quirk,
    hits.cc:491-499)."""
    import io as _io
    import sys
    from contextlib import redirect_stderr, redirect_stdout

    from swipe_tpu.cli import main as cli_main

    def ours(args, inp=None):
        buf, err = _io.StringIO(), _io.StringIO()
        old = sys.stdin
        if inp is not None:
            sys.stdin = _io.TextIOWrapper(_io.BytesIO(inp),
                                          encoding="latin-1")
        try:
            with redirect_stdout(buf), redirect_stderr(err):
                try:
                    rc = cli_main(args + ["--backend", "lax"])
                except SystemExit as e:
                    rc = e.code or 0
        finally:
            sys.stdin = old
        return rc, buf.getvalue(), err.getvalue()

    base = ["-d", str(dbs / "prot")]
    cases = [
        (base + ["-p", "blastp", "-i", str(dbs / "qp.fa"), "-m", "9",
                 "-G", "11x", "-E", "1x", "-e", "10.0x"], None),
        (base + ["-p", "blastp", "-i", str(dbs / "qp.fa"), "-m", "9",
                 "stray_positional.fa"], None),
        (base + ["-p", "blastp", "-m", "9"],
         b">empty record\n\n>q2 real\nARNDCQEGHILKMFPSTWYV\n"),
        (base + ["-p", "blastp", "-m", "0", "-k", "0.001"],
         b">empty record\n\n"),
        (base + ["-p", "tblastx", "-S", "2", "-i", str(dbs / "qp.fa")],
         None),
    ]
    for args, inp in cases:
        r = subprocess.run([ref_swipe] + args, capture_output=True,
                           timeout=300, input=inp)
        rc, out, err = ours(args, inp)
        assert rc == r.returncode, (args, r.stderr, err)
        assert _normalize(out) == _normalize(r.stdout.decode()), (
            f"quirk mismatch for {args}\n" + "\n".join(
                _first_diff(_normalize(r.stdout.decode()),
                            _normalize(out))))
        assert err.strip() == r.stderr.decode().strip(), args


def test_golden_overlong_header_line(ref_swipe, dbs, tmp_path):
    """The reference reads queries with fgets(LINE_MAX=2048): a header
    line longer than 2047 bytes is split — the tail chunk feeds the
    SEQUENCE map (query.cc:274-330).  Byte parity includes this quirk."""
    rng = np.random.default_rng(91)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    qp = "".join(rng.choice(AAl, 50))
    # 2500-char header whose tail contains mappable residues; the real
    # sequence follows on the next line
    longdesc = "q_long " + "x" * 2300 + "".join(rng.choice(AAl, 160))
    (tmp_path / "q.fa").write_text(f">{longdesc}\n{qp}\n")
    args = ["-p", "blastp", "-m", "9", "-e", "1000",
            "-d", str(dbs / "prot"), "-i", str(tmp_path / "q.fa")]
    ref_out = _normalize(run_ref(ref_swipe, args))
    our_out = _normalize(run_ours(args))
    assert our_out == ref_out, "\n".join(_first_diff(ref_out, our_out))


def test_golden_unopenable_query(ref_swipe, dbs, tmp_path):
    """fopen failures (a missing path) produce the reference's clean
    fatal before any output (query.cc:193-194); a DIRECTORY is the C
    quirk case — fopen succeeds, reads fail, and the run completes with
    zero queries."""
    import io as _io
    from contextlib import redirect_stderr, redirect_stdout

    from swipe_tpu.cli import main as cli_main
    qdir = tmp_path / "qdir"
    qdir.mkdir()

    def ours(args):
        buf, err = _io.StringIO(), _io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            try:
                rc = cli_main(args + ["--backend", "lax"])
            except SystemExit as e:
                rc = e.code or 0
        return rc, buf.getvalue(), err.getvalue()

    base = ["-p", "blastp", "-d", str(dbs / "prot"), "-i"]
    # missing file: both fatal with the same message
    args = base + [str(tmp_path / "nope.fa")]
    r = subprocess.run([ref_swipe] + args, capture_output=True, timeout=60)
    rc, out, err = ours(args)
    assert rc == r.returncode == 1
    assert err.strip() == r.stderr.decode().strip() \
        == "Cannot open query file."
    # directory: both run to completion with no queries
    args = base + [str(qdir)]
    r = subprocess.run([ref_swipe] + args, capture_output=True, timeout=60)
    rc, out, err = ours(args)
    assert rc == r.returncode == 0
    assert _normalize(out) == _normalize(r.stdout.decode())


def test_golden_dump_ignores_msk(ref_swipe, tmp_path):
    """-N dump iterates every seqno and filters only per defline
    (membership bits/taxid, swipe.cc:2539-2545 -> db_parse_header); the
    .msk oid bitmap the SEARCH phase honors is never consulted, so a
    sequence whose msk bit is clear but whose defline memberships pass
    still dumps."""
    import struct

    from swipe_tpu.io.asn1 import Defline
    rng = np.random.default_rng(92)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    n = 8
    seqs, dls = [], []
    for i in range(n):
        seqs.append(encode("".join(rng.choice(AAl, 40)), MAP_NCBI_AA))
        dls.append([Defline(title=f"dk{i} dump-msk {i}", memberships=1)])
    write_blastdb(str(tmp_path / "base"), seqs, dls, "aa",
                  title="dump msk base", date="Jan 1, 2026  12:00 AM")
    # msk keeps only EVEN oids, but every defline has the membership bit
    bits = bytearray((n + 7) // 8)
    nres = 0
    for i in range(0, n, 2):
        bits[i // 8] |= 1 << (7 - (i % 8))
        nres += len(seqs[i])
    (tmp_path / "sub.msk").write_bytes(struct.pack(">I", n) + bytes(bits))
    (tmp_path / "sub.pal").write_text(
        "TITLE  dump msk subset\nDBLIST base\nOIDLIST sub.msk\n"
        "LENGTH %d\nNSEQ %d\nMAXOID %d\nMEMB_BIT 1\n"
        % (nres, n // 2, n - 1))
    for dump in ("1", "2"):
        args = ["-d", str(tmp_path / "sub"), "-N", dump]
        ref_out = _normalize(run_ref(ref_swipe, args))
        our_out = _normalize(run_ours(args))
        assert "dk1" in our_out     # odd oid: msk-excluded, still dumped
        assert our_out == ref_out, "\n".join(_first_diff(ref_out, our_out))


def test_golden_stdin_query(ref_swipe, dbs):
    """Queries on standard input: explicit `-i -` and the no-flag default
    both read stdin (query.cc uses '-' as the default query filename)."""
    import io as _io
    import sys
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main as cli_main

    qbytes = (dbs / "qp.fa").read_bytes()
    for args in (["-p", "blastp", "-m", "9", "-d", str(dbs / "prot"),
                  "-i", "-"],
                 ["-p", "blastp", "-m", "0", "-d", str(dbs / "prot")]):
        r = subprocess.run([ref_swipe] + args, capture_output=True,
                           timeout=300, input=qbytes)
        assert r.returncode == 0, r.stderr.decode()[-500:]
        buf = _io.StringIO()
        old_stdin = sys.stdin
        # the query reader wraps sys.stdin.buffer (io/fasta.py:122)
        sys.stdin = _io.TextIOWrapper(_io.BytesIO(qbytes),
                                      encoding="latin-1")
        try:
            with redirect_stdout(buf):
                rc = cli_main(args + ["--backend", "lax"])
        finally:
            sys.stdin = old_stdin
        assert rc == 0
        ref_out = _normalize(r.stdout.decode())
        our_out = _normalize(buf.getvalue())
        assert our_out == ref_out, (
            f"stdin-query mismatch for {args}\n"
            + "\n".join(_first_diff(ref_out, our_out)))


def _first_diff(a: str, b: str, n: int = 6):
    la, lb = a.splitlines(), b.splitlines()
    out = []
    for i in range(max(len(la), len(lb))):
        xa = la[i] if i < len(la) else "<EOF>"
        xb = lb[i] if i < len(lb) else "<EOF>"
        if xa != xb:
            out.append(f"line {i}: ref={xa!r}")
            out.append(f"line {i}: our={xb!r}")
            if len(out) >= 2 * n:
                break
    return out


def test_golden_long_db_sequence(ref_swipe, tmp_path):
    """Chromosome-scale db sequences: a 60 kb member exceeds the engine's
    chunk budget and streams through the carry series
    (batching.pack_stream_carry); output must stay byte-identical for
    blastn and tblastn (the reference streams unbounded db sequences with
    O(qlen) state, search7.cc:787)."""
    rng = np.random.default_rng(44)
    NT = list("ACGT")
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    qn = "".join(rng.choice(NT, 90))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    qrc = "".join(comp[c] for c in reversed(qn))
    # > 65536 so the STREAM backend also classifies it as giant: below
    # that the stream subcase packs one 70k-tall chunk; through the
    # segmented route the pieces pack ~70x shorter
    giant = ("".join(rng.choice(NT, 40000)) + qn
             + "".join(rng.choice(NT, 20000)) + qrc
             + "".join(rng.choice(NT, 10000)))
    seqs, descs = [], []
    for i in range(10):
        seqs.append(encode("".join(rng.choice(NT,
                                              int(rng.integers(50, 200)))),
                           MAP_NCBI_NT16))
        descs.append(f"short{i} small nt {i}")
    seqs.append(encode(giant, MAP_NCBI_NT16))
    descs.append("chr1 long synthetic sequence")
    write_blastdb(str(tmp_path / "longdb"), seqs, make_deflines(descs), "nt",
                  title="long-seq golden db", date="Jan 1, 2026  12:00 AM")
    (tmp_path / "qn.fa").write_text(f">qlong nt query\n{qn}\n")
    qp = "".join(rng.choice(AAl, 60))
    (tmp_path / "qp.fa").write_text(f">qlongp aa query\n{qp}\n")
    for i, args in enumerate(
            (["-p", "blastn", "-m", "9", "-i", str(tmp_path / "qn.fa")],
             ["-p", "blastn", "-m", "0", "-b", "3",
              "-i", str(tmp_path / "qn.fa")],
             ["-p", "tblastn", "-m", "9", "-e", "1000",
              "-i", str(tmp_path / "qp.fa")])):
        full = args + ["-d", str(tmp_path / "longdb")]
        ref_out = _normalize(run_ref(ref_swipe, full))
        our_out = _normalize(run_ours(full))
        assert "chr1" in our_out
        assert our_out == ref_out, (
            f"long-seq mismatch for {args}\n"
            + "\n".join(_first_diff(ref_out, our_out)))
        if i == 0:
            # the stream backend routes the lone giant through exact
            # overlapped segmentation — keep it in the byte-parity loop
            wf_out = _normalize(run_ours(full, backend="stream"))
            assert wf_out == ref_out, (
                "segmented long-seq mismatch\n"
                + "\n".join(_first_diff(ref_out, wf_out)))


def test_golden_asymmetric_matrix(ref_swipe, dbs, tmp_path):
    """Custom asymmetric -M files: the reference scores
    matrix[db_row][query_col] (align.cc:86), so the parsed file must be
    transposed into our [query, db] convention."""
    rng = np.random.default_rng(33)
    AAl = "ARNDCQEGHILKMFPSTWYV"
    vals = rng.integers(-4, 9, size=(20, 20))
    lines = ["# asymmetric fuzz matrix", "   " + "  ".join(AAl)]
    for i, c in enumerate(AAl):
        lines.append(c + " " + " ".join("%2d" % v for v in vals[i]))
    mf = tmp_path / "asym.mat"
    mf.write_text("\n".join(lines) + "\n")
    args = ["-p", "blastp", "-m", "9", "-M", str(mf), "-G", "10", "-E", "2",
            "-e", "1000", "-d", str(dbs / "prot"), "-i", str(dbs / "qp.fa")]
    ref_out = _normalize(run_ref(ref_swipe, args))
    our_out = _normalize(run_ours(args))
    assert our_out == ref_out, "\n".join(_first_diff(ref_out, our_out))


def test_golden_gi_dump(ref_swipe, tmp_path):
    """-N dumps force gi rendering (db_show_fasta, database.cc:1504)."""
    from swipe_tpu.io.asn1 import Defline, SeqId
    rng = np.random.default_rng(91)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    seqs, dls = [], []
    for i in range(6):
        s = "".join(rng.choice(AAl, int(rng.integers(20, 120))))
        seqs.append(encode(s, MAP_NCBI_AA))
        d = [Defline(title=f"gi dump seq {i}",
                     seqids=[SeqId("gi", number=2000 + i),
                             SeqId("sp", accession=f"Q{i:05d}", version=1,
                                   name=f"DMP{i}_HUMAN")])]
        if i == 2:
            d.append(Defline(title="second name",
                             seqids=[SeqId("gi", number=7777)]))
        dls.append(d)
    write_blastdb(str(tmp_path / "gidump"), seqs, dls, "aa",
                  title="gi dump db", date="Jan 1, 2026  12:00 AM")
    for dump in ("1", "2"):
        args = ["-p", "blastp", "-d", str(tmp_path / "gidump"), "-N", dump]
        ref_out = _normalize(run_ref(ref_swipe, args))
        our_out = _normalize(run_ours(args))
        assert "gi|2000" in our_out
        assert our_out == ref_out, "\n".join(_first_diff(ref_out, our_out))
