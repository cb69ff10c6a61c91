#!/usr/bin/env python3
"""Wall seconds of each phase of ``chip_smoke.py`` for several checkouts
of the port, run one after another within one card call, to tell which
phase a change in the whole run's time comes from.

    python3 port_scripts/ab_smoke_phases.py TREE [TREE ...]

Each TREE (a directory holding ``chip_smoke.py`` and ``raft_tpu_torch``,
e.g. ``git archive``s of a commit and of its parent under the git-ignored
``build/``) runs ``python3 chip_smoke.py`` from its root, in the order
given (parent, change, change, parent), with its ``build/kernels`` removed
first, so every run compiles its kernels as a fresh checkout does. Each
line the run prints is stamped with the seconds since it started, and the
phases are cut at the first line of each that every version of the
script prints (``MARKS``; ``build`` runs from the start to the first
mark). Each run's stamped output goes to
``chiprun_out/ab_smoke_phases_<i>.log``; after the card's name and power
limit, one JSON line a run gives its exit code, its wall seconds and the
seconds of each phase. Exits 1 if a run failed.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (phase, the start of the first line it prints), in the script's order
MARKS = [("twins", "K1 vs twin "), ("main_path", "prepare (p1 + p3)"),
         ("serving", "serving brute_bf16"), ("ivf", "ivf build f32"),
         ("ivf_pq", "ivf_pq build pq8"), ("spectral", "spectral_g22 fit"),
         ("pairwise_stats", "K8 vs twin main"), ("select_k", "K3 vs twin"),
         ("wide_knn", "wide prepare"),
         ("summary", '{"nonfinite_k1_k2"')]


def run(tree: str, log_path: str) -> dict:
    shutil.rmtree(os.path.join(tree, "build", "kernels"), ignore_errors=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    seen = {}
    last = ""
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            t = time.perf_counter() - t0
            log.write(f"{t:9.2f} {line}")
            for name, mark in MARKS:
                if name not in seen and line.startswith(mark):
                    seen[name] = t
            if line.strip():
                last = line.strip()
        rc = proc.wait()
    wall = time.perf_counter() - t0
    cuts = [("build", 0.0)] + [(n, seen[n]) for n, _ in MARKS if n in seen]
    ends = [t for _, t in cuts[1:]] + [wall]
    return {"tree": tree, "rc": rc, "ok_line": last.startswith('{"ok": true'),
            "wall_s": wall,
            "phase_s": {n: e - t for (n, t), e in zip(cuts, ends)}}


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import gpu_name_power

    print(gpu_name_power(), flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    failed = False
    for i, tree in enumerate(trees):
        row = run(os.path.abspath(tree),
                  os.path.join(out_dir, f"ab_smoke_phases_{i}.log"))
        print(json.dumps(row), flush=True)
        failed |= row["rc"] != 0 or not row["ok_line"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
