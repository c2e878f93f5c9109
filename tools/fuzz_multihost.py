"""Multi-host fuzzer: random (db, query, flags) cases, 2 processes vs 1.

The multi-host runner (parallel.multihost) must produce output
byte-identical to the single-process CLI for ANY legal search — the
acceptance bar the reference's mpiswipe meets vs swipe
(/root/reference/swipe.cc:1793-2434).  Each case writes a random FASTA
db (protein or nucleotide, occasionally with one chromosome-scale
member so the giant exchange path is exercised), picks random flags,
runs the CLI once single-process and once as 2 "hosts"
(jax.distributed over gloo, 2 virtual CPU devices each), and compares
normalized outputs.

Usage: python tools/fuzz_multihost.py [N_CASES] [SEED]
"""

import io
import os
import re
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# the fuzzers compare CPU runs; JAX reads the platform from this
os.environ["JAX_PLATFORMS"] = "cpu"
AA = list("ARNDCQEGHILKMFPSTWYVBZX")
NT = list("ACGTACGTACGTACGTRYN")

VOLATILE = re.compile(
    r"^(Search started|Search completed|Elapsed|Speed|# SWIPE|"
    r"\s*<searchStarted>|\s*<searchCompleted>|\s*<searchElapsedTime>|"
    r"\s*<searchSpeed>)")


def normalize(text: str) -> str:
    return "\n".join(
        l for l in text.splitlines() if not VOLATILE.match(l))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_single(args) -> str:
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(args + ["--backend", "lax"])
    if rc != 0:
        raise RuntimeError(f"single-process run failed rc={rc}")
    return buf.getvalue()


def run_multi(workdir, args, nproc=2) -> str:
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("SWIPE_TPU_NO_COMPILE_CACHE", None)
    outfile = os.path.join(workdir, "multi.txt")
    procs = []
    for r in range(nproc):
        cmd = [sys.executable, "-m", "swipe_tpu.cli"] + args + [
            "--backend", "lax", "--mh-procs", str(nproc),
            "--mh-rank", str(r), "--mh-coord", f"localhost:{port}"]
        if r == 0:
            cmd += ["-o", outfile]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=workdir,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    errs = []
    ok = True
    for p in procs:
        _, err = p.communicate(timeout=600)
        errs.append(err.decode()[-2000:])
        ok = ok and p.returncode == 0
    if not ok:
        raise RuntimeError("multi-process run failed:\n" + "\n".join(errs))
    with open(outfile) as f:
        return f.read()


def random_case(rng, d):
    """Write db + query files into ``d``; return the CLI arg list."""
    is_nt_db = bool(rng.integers(0, 2))
    alpha = NT if is_nt_db else AA
    ndb = int(rng.integers(5, 80))
    seqs = []
    for i in range(ndb):
        n = int(rng.integers(10, 300))
        seqs.append("".join(rng.choice(alpha, n)))
    if is_nt_db:
        prog = str(rng.choice(["blastn", "tblastn", "tblastx"]))
    else:
        prog = str(rng.choice(["blastp", "blastx"]))
    # occasionally one chromosome-scale member (giant exchange path);
    # skipped for tblastx, whose 36 frame-pairs make a giant case
    # minutes-slow on the CPU lax backend
    if rng.integers(0, 3) == 0 and prog != "tblastx":
        gi = int(rng.integers(0, ndb))
        seqs[gi] = "".join(rng.choice(alpha, int(rng.integers(16600,
                                                              20000))))
    with open(os.path.join(d, "db.fa"), "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i} fuzz seq {i}\n{s}\n")

    q_nt = prog in ("blastn", "blastx", "tblastx")
    qalpha = NT if q_nt else AA
    nq = int(rng.integers(1, 4))
    with open(os.path.join(d, "q.fa"), "w") as f:
        for i in range(nq):
            q = "".join(rng.choice(qalpha, int(rng.integers(15, 120))))
            # sometimes plant a db substring for guaranteed strong hits
            if rng.integers(0, 2) == 0:
                src = seqs[int(rng.integers(0, ndb))]
                if len(src) > 30 and (q_nt == is_nt_db):
                    q = src[: int(rng.integers(20, min(80, len(src))))]
            f.write(f">q{i} fuzz query {i}\n{q}\n")

    args = ["-p", prog, "-i", os.path.join(d, "q.fa"),
            "-d", os.path.join(d, "db.fa")]
    args += ["-m", str(rng.choice([0, 7, 8, 9, 99]))]
    args += ["-e", str(rng.choice([10, 1000, 1e6]))]
    if rng.integers(0, 2):
        args += ["-v", str(int(rng.integers(0, 30))),
                 "-b", str(int(rng.integers(0, 20)))]
    if rng.integers(0, 4) == 0:
        args += ["-c", str(int(rng.integers(0, 40)))]
    if rng.integers(0, 4) == 0:
        args += ["-u", str(int(rng.integers(30, 200)))]
    if prog == "blastn" and rng.integers(0, 3) == 0:
        args += ["-S", str(rng.choice([1, 2, 3]))]
    if prog == "blastn" and rng.integers(0, 4) == 0:
        # incl. penalties outside int8 (the wide-matrix lax route)
        args += ["-r", str(int(rng.integers(1, 5))),
                 "-q", str(-int(rng.choice([2, 4, 150, 300])))]
    if not q_nt or prog in ("blastx", "tblastx"):
        if rng.integers(0, 3) == 0:
            args += ["-M", str(rng.choice(["BLOSUM50", "BLOSUM80",
                                           "PAM30"]))]
    return args


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    rng = np.random.default_rng(seed)
    fails = 0
    for case in range(n):
        with tempfile.TemporaryDirectory() as d:
            args = random_case(rng, d)
            try:
                single = normalize(run_single(args))
            except RuntimeError:
                # case is not single-process-legal either; skip
                continue
            try:
                multi = normalize(run_multi(d, args))
            except RuntimeError as e:
                fails += 1
                print(f"case {case}: MULTI RUN FAILED  args={args}\n{e}",
                      flush=True)
                continue
            if multi != single:
                fails += 1
                import difflib
                diff = "\n".join(list(difflib.unified_diff(
                    single.splitlines(), multi.splitlines(),
                    "single", "multi"))[:40])
                print(f"case {case}: OUTPUT DIFFERS  args={args}\n{diff}",
                      flush=True)
    print(f"fuzz_multihost: {n} cases, {fails} failed")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
