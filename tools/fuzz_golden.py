"""Golden fuzzer: random (db, query, flags) cases vs the reference binary.

Builds the reference swipe once (x86), then loops: write a random BLAST v4
db with our writer, run both programs with random flag combinations, and
byte-compare normalized outputs.  Prints each failing case's repro command
and first diff; exits nonzero if any case failed.

Usage: python tools/fuzz_golden.py [N_CASES] [SEED]
"""

import io
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from swipe_tpu.alphabet import MAP_NCBI_AA, MAP_NCBI_NT16, encode  # noqa: E402
from swipe_tpu.io.blastdb_writer import make_deflines, write_blastdb  # noqa: E402

REF_SRC = "/root/reference"
REF_BIN_DIR = "/tmp/swipe_tpu_refbuild"
AA = list("ARNDCQEGHILKMFPSTWYVBZX")
NT = list("ACGTACGTACGTACGTRYN")  # mostly unambiguous, some ambiguity

VOLATILE = re.compile(
    r"^(SWIPE|swipe-tpu|Search started|Search completed|Elapsed|Speed|"
    r"# SWIPE|Database time|\s*<programVersion>|\s*<searchStarted>|"
    r"\s*<searchCompleted>|\s*<searchElapsedTime>|\s*<searchSpeed>|"
    r"\s*<queryFilename>|\s*<databaseFilename>|\s*<databaseDate>|"
    r"\s*<threads>)")


def normalize(text):
    text = "\n".join(l for l in text.splitlines() if not VOLATILE.match(l))
    # -m 7 <len> of hits beyond -b: the reference prints uninitialized
    # memory there (hits.cc:560-567); we print the true length.  Blank the
    # field in <hit> blocks that carry no <alignment>.
    if "<result>" in text:
        blocks = re.split(r"(    <hit>\n.*?    </hit>\n)", text,
                          flags=re.S)
        out = []
        for b in blocks:
            if b.startswith("    <hit>") and "<alignment>" not in b:
                b = re.sub(r"<len>\d+</len>", "<len>*</len>", b)
            out.append(b)
        text = "".join(out)
    return text


def build_ref():
    binpath = os.path.join(REF_BIN_DIR, "swipe")
    if not os.path.exists(binpath):
        shutil.copytree(REF_SRC, REF_BIN_DIR, dirs_exist_ok=True)
        subprocess.run(["make", "-j4", "swipe"], cwd=REF_BIN_DIR, check=True,
                       capture_output=True)
    return binpath


def run_ours(args, backend="lax", stdin_bytes=None):
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main
    buf = io.StringIO()
    old_stdin = sys.stdin
    if stdin_bytes is not None:
        # the query reader wraps sys.stdin.buffer (io/fasta.py), which a
        # TextIOWrapper over BytesIO provides
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin_bytes),
                                     encoding="latin-1")
    try:
        with redirect_stdout(buf):
            rc = main(args + ["--backend", backend])
    finally:
        sys.stdin = old_stdin
    assert rc == 0
    return buf.getvalue()


def one_case(ref_bin, d, rng, case):
    mode = rng.choice(["blastp", "blastn", "blastx", "tblastn", "tblastx"])
    protdb = mode in ("blastp", "blastx")
    alpha, cmap, dbt = (AA, MAP_NCBI_AA, "aa") if protdb else \
        (NT, MAP_NCBI_NT16, "nt")
    big = rng.random() < 0.05
    nseq = int(rng.integers(150, 500)) if big else int(rng.integers(3, 40))
    maxlen = 1500 if big else 200
    seqs, descs = [], []
    for i in range(nseq):
        s = "".join(rng.choice(alpha, int(rng.integers(3, maxlen))))
        seqs.append(encode(s, cmap))
        descs.append(f"fz{i} fuzz sequence {i} with words")
    if not big and rng.random() < 0.05:
        # one chromosome-scale subject (beyond the engine's giant
        # threshold, max_cols=16384 on the lax route): drives the
        # exact-overlapped-segmentation carry path through the full
        # CLI -> kernel -> top-K -> report chain vs the reference
        s = "".join(rng.choice(alpha, int(rng.integers(18_000, 30_000))))
        seqs.append(encode(s, cmap))
        descs.append(f"fz{nseq} fuzz giant subject {nseq}")
        nseq += 1
    taxids = None
    if rng.random() < 0.12:
        taxids = [int(rng.integers(1, 9)) * 100 for _ in range(nseq)]

    def deflines(lo, hi):
        return make_deflines(descs[lo:hi],
                             taxids=taxids[lo:hi] if taxids else None)

    dbp = os.path.join(d, f"db{case}")
    if rng.random() < 0.10 and nseq >= 4:
        # two volumes + DBLIST alias (paths relative to the alias file)
        cut = nseq // 2
        for v, (lo, hi) in enumerate(((0, cut), (cut, nseq))):
            write_blastdb(f"{dbp}v{v}", seqs[lo:hi], deflines(lo, hi), dbt,
                          title=f"fuzz vol {case}.{v}",
                          date="Jun 6, 2025  6:06 PM")
        ext = "pal" if protdb else "nal"
        with open(f"{dbp}.{ext}", "w") as f:
            f.write(f"TITLE  fuzz alias {case}\n"
                    f"DBLIST db{case}v0 db{case}v1\n")
    else:
        write_blastdb(dbp, seqs, deflines(0, nseq), dbt,
                      title=f"fuzz db {case}", date="Jun 6, 2025  6:06 PM")

    qalpha = AA if mode in ("blastp", "tblastn") else NT
    nq = int(rng.integers(1, 4))
    qf = os.path.join(d, f"q{case}.fa")
    with open(qf, "w") as f:
        for qi in range(nq):
            qmax = 1200 if rng.random() < 0.05 else 150   # long queries:
            # row caps, hint binning, length-adjustment regimes
            q = "".join(rng.choice(qalpha, int(rng.integers(8, qmax))))
            desc = f">fq{case}_{qi} fuzz query {case}.{qi}"
            if rng.random() < 0.08:
                desc = ">"        # empty description (query_show parity)
            if rng.random() < 0.04:
                # header beyond fgets' 2047-byte buffer: the tail chunk
                # feeds the SEQUENCE map (query.cc LINE_MAX quirk)
                desc += " " + "padword " * int(rng.integers(260, 400)) \
                    + "".join(rng.choice(qalpha, 60))
            if rng.random() < 0.04:
                q = ""            # empty record: Kmn = 0 thresholds
            f.write(f"{desc}\n{q}\n")

    # occasional database-dump case (-N 1/2): no search at all
    if rng.random() < 0.04:
        args = ["-d", dbp, "-N", str(int(rng.integers(1, 3)))]
        r = subprocess.run([ref_bin] + args, capture_output=True,
                           timeout=120)
        if r.returncode != 0:
            return None
        ours = normalize(run_ours(args))
        if normalize(r.stdout.decode()) != ours:
            return f"CASE {case} FAILED (dump): {' '.join(args)}"
        return ""

    args = ["-p", mode, "-d", dbp, "-i", qf,
            "-m", str(rng.choice([0, 7, 8, 9, 99]))]
    if rng.random() < 0.3:
        args += ["-e", str(rng.choice([0.1, 1.0, 100.0]))]
    if rng.random() < 0.2:
        args += ["-k", str(rng.choice([1e-5, 0.01]))]
    if rng.random() < 0.3:
        args += ["-b", str(int(rng.integers(0, 6))),
                 "-v", str(int(rng.integers(1, 10)))]
    if rng.random() < 0.2:
        args += ["-c", str(int(rng.integers(1, 30)))]
    if rng.random() < 0.15:
        args += ["-u", str(int(rng.integers(20, 120)))]
    if rng.random() < 0.25 and mode != "blastn":
        args += ["-M", str(rng.choice(["BLOSUM50", "BLOSUM80", "PAM70"])),
                 "-G", "10", "-E", "1"]
    elif rng.random() < 0.2 and mode != "blastn":
        # standalone gap costs, incl. rows with no KA table (the
        # statistics-unavailable warning path)
        args += ["-G", str(int(rng.integers(6, 16))),
                 "-E", str(int(rng.integers(1, 3)))]
    if mode == "blastn" and rng.random() < 0.3:
        rw, pn = [(1, -2), (1, -3), (1, -4), (2, -3), (4, -5),
                  (1, -1)][int(rng.integers(0, 6))]
        args += ["-r", str(rw), "-q", str(pn)]
    if rng.random() < 0.2 and mode in ("blastn", "blastx", "tblastx"):
        args += ["-S", str(int(rng.integers(1, 4)))]
    if rng.random() < 0.2:
        args += ["-I"]
    if rng.random() < 0.1:
        args += ["-H"]
    if rng.random() < 0.1:
        args += ["-a", str(int(rng.integers(1, 5)))]
    if rng.random() < 0.15:
        args += ["-z", str(int(rng.integers(1000, 10_000_000)))]
    if rng.random() < 0.15 and mode in ("blastx", "tblastx"):
        args += ["-Q", str(rng.choice([1, 2, 5, 11]))]
    if rng.random() < 0.15 and mode in ("tblastn", "tblastx"):
        args += ["-D", str(rng.choice([1, 4]))]
    if taxids and rng.random() < 0.8:
        txf = os.path.join(d, f"tx{case}.txt")
        pool = sorted(set(taxids))
        pick = rng.choice(pool, size=int(rng.integers(1, len(pool) + 1)),
                          replace=False)
        with open(txf, "w") as f:
            f.write("".join(f"{t}\n" for t in sorted(pick)))
        args += ["-x", txf]

    # stdin queries: explicit `-i -` or the no-flag default (both stdin)
    stdin_bytes = None
    if rng.random() < 0.08:
        with open(qf, "rb") as fh:
            stdin_bytes = fh.read()
        i = args.index("-i")
        if rng.random() < 0.5:
            args[i + 1] = "-"
        else:
            del args[i:i + 2]

    r = subprocess.run([ref_bin] + args, capture_output=True, timeout=120,
                       input=stdin_bytes)
    if r.returncode != 0:
        return None  # reference rejected the combination; skip
    ref_out = normalize(r.stdout.decode())
    extra = ["--batch", str(int(rng.integers(2, 5)))] \
        if rng.random() < 0.2 else []
    # a few cases per run drive the production stream route (the lax
    # twin on the CPU) through the full CLI->kernel->top-K->report chain
    backend = "stream" if (not big and rng.random() < 0.03) \
        else "lax"
    our_out = normalize(run_ours(args + extra, backend, stdin_bytes))
    if ref_out != our_out:
        la, lb = ref_out.splitlines(), our_out.splitlines()
        diffs = []
        for i in range(max(len(la), len(lb))):
            xa = la[i] if i < len(la) else "<EOF>"
            xb = lb[i] if i < len(lb) else "<EOF>"
            if xa != xb:
                diffs.append(f"  line {i}: ref={xa!r}\n  line {i}: our={xb!r}")
                if len(diffs) >= 3:
                    break
        return "CASE %d FAILED: %s\n%s" % (case, " ".join(args),
                                           "\n".join(diffs))
    return ""


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    ref_bin = build_ref()
    rng = np.random.default_rng(seed)
    d = tempfile.mkdtemp(prefix="swfuzz")
    fails = skipped = 0
    for case in range(n):
        res = one_case(ref_bin, d, rng, case)
        if res is None:
            skipped += 1
        elif res:
            fails += 1
            print(res, flush=True)
    print(f"fuzz: {n} cases, {fails} failed, {skipped} skipped")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
