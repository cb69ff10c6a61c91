#!/usr/bin/env python3
"""K1's unpacked forms' device time at unpacked_knn's two shapes for
several checkouts of the port, to compare two commits within one card
call.

    python3 port_scripts/ab_unpacked.py [--sweep] TREE [TREE ...]

Each TREE (a directory holding ``raft_tpu_torch``, e.g. this checkout and
a ``git archive`` of its parent under the git-ignored ``build/``) runs in
its own process, in the order given (run parent, change, change, parent),
and builds its own ``fused_l2_topk.cu``: make_blobs 1,000,000 × 128 (64
clusters, std 2.0, seed 0; the first 2048 rows as queries) and
1,000,000 × 960 (seed 13; the first 1000 rows), each prepared with T =
512, g = 4096, passes 3 (one group past the packed envelope); then the
unpacked form (``fused_l2_group_topk``) and its d-chunked form
(``_dchunk``) timed over 3 launches between two CUDA events after a
warm-up, at the tree's own segment count and, where the tree takes a
``segments`` argument, at one segment (with ``--sweep``, at 1, 2, 4, 8
and 16 segments too). Each tree prints one JSON line
with the times and a digest of the five outputs' bytes; the digests of
every tree must agree (the split gives the same bits), else the script
exits 1.
"""

import hashlib
import json
import os
import subprocess
import sys


def measure(root: str, sweep: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import inspect

    import torch
    import raft_tpu_torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.random import make_blobs

    def cuda_ms(fn, reps=3):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    out = {"tree": root}
    for name, seed, d, nq in (("main", 0, 128, 2048), ("wide", 13, 960,
                                                       1000)):
        X, _ = make_blobs(res, seed, 1_000_000, d, n_clusters=64,
                          cluster_std=2.0)
        idx = distance.prepare_knn_index(X, T=512, g=4096, passes=3)
        x = X[:nq]
        pad = idx.stream_width - d
        if pad:
            x = torch.cat([x, x.new_zeros((nq, pad))], 1)
        x = x.contiguous()
        kern = (k1.fused_l2_group_topk_dchunk if x.shape[1] > 512
                else k1.fused_l2_group_topk)
        args = (x, idx.y_hi, idx.y_lo, idx.yyh_k)
        kw = dict(T=idx.T, g=idx.g, passes=idx.passes)
        h = hashlib.sha256()
        for t in kern(*args, **kw):
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[f"{name}_digest"] = h.hexdigest()[:16]
        out[f"{name}_ms"] = cuda_ms(lambda: kern(*args, **kw))
        if "segments" in inspect.signature(kern).parameters:
            out[f"{name}_ms_one_segment"] = cuda_ms(
                lambda: kern(*args, **kw, segments=1))
            if sweep:
                out[f"{name}_ms_by_segments"] = {
                    S: cuda_ms(lambda: kern(*args, **kw, segments=S))
                    for S in (1, 2, 4, 8, 16)}
        del X, idx, x, args
        torch.cuda.empty_cache()
    return out


def main() -> int:
    sweep = "--sweep" in sys.argv[1:]
    trees = [a for a in sys.argv[1:] if a != "--sweep"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if os.environ.get("AB_UNPACKED_TREE"):
        print(json.dumps(measure(os.environ["AB_UNPACKED_TREE"], sweep)),
              flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from chip_smoke import gpu_name_power

    print(gpu_name_power(), flush=True)
    digests = set()
    for tree in trees:
        env = dict(os.environ, AB_UNPACKED_TREE=tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               *sys.argv[1:]], env=env, capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        digests.add((row["main_digest"], row["wide_digest"]))
    if len(digests) != 1:
        print(f"ab_unpacked: the trees' outputs differ: {digests}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
