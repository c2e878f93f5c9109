"""DB-reader fuzzer: randomized deflines + alias graphs vs the reference.

Each case builds a random BLAST v4 artifact — deflines drawn over EVERY
Seq-id choice (tests/test_golden_fuzz_db.random_defline), a random alias
topology (flat volume / nested alias / diamond / subdir / masked
subset), and occasionally an injected corruption (missing or empty
files, wrong version) — then runs the reference binary and our CLI on
it and byte-compares normalized stdout (or, for corrupt cases, stderr
and the exit code).  Prints failing repros; exits nonzero on any
mismatch.

Usage: python tools/fuzz_blastdb.py [N_CASES] [SEED]
"""

import io
import os
import shutil
import struct
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from swipe_tpu.alphabet import MAP_NCBI_AA, encode  # noqa: E402
from swipe_tpu.io.asn1 import Defline  # noqa: E402

from test_golden_foreign_db import _write_volume, _msk  # noqa: E402
from test_golden_fuzz_db import (random_defline, run_ours_fail,  # noqa: E402
                                 run_ref_fail)
from test_golden_parity import (REF_BIN_DIR, REF_SRC,  # noqa: E402
                                _normalize, run_ours, run_ref)

AA = list("ARNDCQEGHILKMFPSTWYV")


def build_ref():
    binpath = os.path.join(REF_BIN_DIR, "swipe")
    if not os.path.exists(binpath):
        shutil.copytree(REF_SRC, REF_BIN_DIR, dirs_exist_ok=True)
        r = subprocess.run(["make", "-j4", "swipe"], cwd=REF_BIN_DIR,
                           capture_output=True)
        assert r.returncode == 0, r.stderr.decode()[-500:]
    return binpath


def _volume(d, name, rng, qp):
    n = int(rng.integers(3, 12))
    seqs, dls = [], []
    for i in range(n):
        s = "".join(rng.choice(AA, int(rng.integers(25, 120))))
        if rng.integers(3) == 0:
            cut = int(rng.integers(3, len(qp) - 10))
            s = s[:4] + qp[cut:cut + 30] + s[4:]
        seqs.append(encode(s, MAP_NCBI_AA))
        dls.append([random_defline(rng)
                    for _ in range(int(rng.integers(1, 3)))])
    _write_volume(os.path.join(d, name), seqs, dls, True, title=name)
    return n


def one_case(ref_bin, rng, case_no):
    d = tempfile.mkdtemp(prefix="fuzzdb_")
    try:
        qp = "".join(rng.choice(AA, int(rng.integers(30, 70))))
        with open(os.path.join(d, "q.fa"), "w") as f:
            f.write(f">q fuzz {case_no}\n{qp}\n")
        topo = int(rng.integers(5))
        if topo == 0:                       # flat volume
            _volume(d, "db", rng, qp)
        elif topo == 1:                     # nested alias over 2 volumes
            _volume(d, "v0", rng, qp)
            _volume(d, "v1", rng, qp)
            with open(os.path.join(d, "mid.pal"), "w") as f:
                f.write("TITLE mid\nDBLIST v0 v1\n")
            with open(os.path.join(d, "db.pal"), "w") as f:
                f.write("TITLE top\nDBLIST mid\n")
        elif topo == 2:                     # diamond
            _volume(d, "v", rng, qp)
            with open(os.path.join(d, "a.pal"), "w") as f:
                f.write("TITLE a\nDBLIST v\n")
            with open(os.path.join(d, "b.pal"), "w") as f:
                f.write("TITLE b\nDBLIST v\n")
            with open(os.path.join(d, "db.pal"), "w") as f:
                f.write("TITLE top\nDBLIST a b\n")
        elif topo == 3:                     # subdir volume
            os.makedirs(os.path.join(d, "sub"), exist_ok=True)
            _volume(os.path.join(d, "sub"), "v", rng, qp)
            with open(os.path.join(d, "db.pal"), "w") as f:
                f.write("TITLE subdir\nDBLIST sub/v\n")
        else:                               # masked subset
            n = _volume(d, "v", rng, qp)
            members = sorted(rng.choice(
                n, size=max(1, int(rng.integers(1, n))), replace=False))
            lens = None
            with open(os.path.join(d, "v.msk"), "wb") as f:
                f.write(_msk(n - 1, [int(x) for x in members]))
            with open(os.path.join(d, "db.pal"), "w") as f:
                f.write("TITLE masked\nDBLIST v\nOIDLIST v.msk\n"
                        "MEMB_BIT 1\nNSEQ %d\nLENGTH 1\nMAXOID %d\n"
                        % (len(members), n - 1))
        corrupt = int(rng.integers(4)) == 0
        if corrupt:
            kind = int(rng.integers(3))
            vols = [f[:-4] for f in os.listdir(d) if f.endswith(".pin")]
            if vols:
                v = os.path.join(d, str(rng.choice(vols)))
                if kind == 0:
                    os.unlink(v + ".psq")
                elif kind == 1:
                    open(v + ".pin", "wb").close()
                else:
                    raw = bytearray(open(v + ".pin", "rb").read())
                    raw[0:4] = struct.pack(">I", int(rng.integers(5, 99)))
                    open(v + ".pin", "wb").write(bytes(raw))
            else:
                corrupt = False
        view = str(rng.choice(["0", "9", "8", "7"]))
        args = ["-d", os.path.join(d, "db"),
                "-i", os.path.join(d, "q.fa"), "-p", "blastp",
                "-e", "1e6", "-m", view]
        if rng.integers(3) == 0:
            args += ["-N", str(rng.choice(["1", "2"]))]
            args = [a for a in args
                    if a not in ("-i", os.path.join(d, "q.fa"),
                                 "-m", view, "-e", "1e6")]
        if corrupt:
            rrc, rerr = run_ref_fail(ref_bin, args)
            orc, oerr = run_ours_fail(args)
            ok = (rerr == oerr and rrc == orc)
            detail = f"stderr {oerr!r} vs {rerr!r}"
        else:
            ref = _normalize(run_ref(ref_bin, args))
            ours = _normalize(run_ours(args))
            ok = ours == ref
            detail = next((f"line {i}: {a!r} != {b!r}" for i, (a, b) in
                           enumerate(zip(ours.splitlines(),
                                         ref.splitlines()))
                           if a != b), "length mismatch")
        if not ok:
            print(f"FAIL case {case_no} (topo {topo}, corrupt {corrupt}): "
                  f"{detail}\n  repro dir kept: {d}\n  args: {args}")
            return False
        shutil.rmtree(d, ignore_errors=True)
        return True
    except Exception as e:
        print(f"ERROR case {case_no}: {type(e).__name__}: {e}\n"
              f"  repro dir kept: {d}")
        return False


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    ref_bin = build_ref()
    rng = np.random.default_rng(seed)
    bad = 0
    for i in range(n):
        if not one_case(ref_bin, rng, i):
            bad += 1
    print(f"{n - bad}/{n} cases passed")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
