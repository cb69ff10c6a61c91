#!/usr/bin/env python3
"""Compare the SASS of the resident packed kernels (K1 and K2,
``packed_sm90_kernel<passes, pair, q8>`` in
``raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu``) of two checkouts:
whether a change to the shared source left the resident instances'
machine code as it was.

    python3 port_scripts/sass_diff_packed.py TREE_A TREE_B

Each TREE is a directory holding ``raft_tpu_torch`` (e.g. this checkout
and a ``git archive`` of its parent under the git-ignored ``build/``).
Both sources are compiled at once with the port's own ``nvcc`` flags into
``build/sass/``, ``cuobjdump -sass`` lists each kernel's instructions
(addresses and encodings dropped), and each resident instance is compared
instruction by instruction. Prints one JSON line: per instance, the
instruction counts of A and B, whether they are equal and the first
differing instructions. Exits 1 if a build fails.
"""

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL = re.compile(r"packed_sm90_kernelILi(\d)ELb(\d)ELb(\d)E")
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass(so: str) -> dict:
    """{instance: [instruction text]} of the resident packed kernels."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = KERNEL.search(line)
            name = (f"p{m.group(1)}{'_pair' if m.group(2) == '1' else ''}"
                    f"{'_q8' if m.group(3) == '1' else ''}") if m else None
            if name is not None:
                res[name] = []
        elif name is not None:
            m = INSN.search(line)
            if m:
                res[name].append(" ".join(m.group(1).split()))
    return res


def main() -> int:
    from raft_tpu_torch.ops import _build

    trees = sys.argv[1:3]
    if len(trees) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "sass")
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = [], []
    for i, tree in enumerate(trees):
        cu = os.path.join(os.path.abspath(tree), "raft_tpu_torch", "ops",
                          "csrc", "fused_l2_packed_sm90.cu")
        so = os.path.join(out_dir, f"packed_{i}.so")
        libs.append(so)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=900)
        if p.returncode:
            print(err[-3000:], file=sys.stderr)
            return 1
    a, b = (sass(so) for so in libs)
    report = {}
    for name in sorted(set(a) | set(b)):
        ia, ib = a.get(name, []), b.get(name, [])
        first = next((k for k, (x, y) in enumerate(zip(ia, ib)) if x != y),
                     None if len(ia) == len(ib) else min(len(ia), len(ib)))
        report[name] = {
            "n_a": len(ia), "n_b": len(ib), "same": ia == ib,
            "differing": sum(x != y for x, y in zip(ia, ib)),
            "first_diff": None if first is None else {
                "at": first, "a": ia[first:first + 4],
                "b": ib[first:first + 4]}}
    print(json.dumps({"trees": trees, "resident_sass": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
