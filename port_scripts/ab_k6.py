#!/usr/bin/env python3
"""CUDA-event times of K6a (SpMV), K6c (SpMM) and K6b (pair SpMV) of
several checkouts of the port within one card call, and of diagnostic
variants of this checkout's K6c.

    python3 port_scripts/ab_k6.py [--variants] TREE [TREE ...]

Each TREE (a directory holding ``raft_tpu_torch``, e.g. this checkout and
a ``git archive`` of its parent) runs in its own process, in the order
given (run parent, change, change, parent): spectral_g22's graph (R-MAT
at scale 22, edge factor 16, seed 3, symmetrized, values 1.0), its
normalized Laplacian's TiledELL, K6a (``ops.spmv.spmv_tiled``), K6c
(``ops.spmv.spmm_tiled``) at V = 16 and 128, and K6b
(``ops.spmv.spmv_pair_tiled``) on the pair layout of the 2²⁰-row band
matrix of half-width 16; each result is held against the tree's twin
within (nnz_i + 2)·2⁻²⁴·Σ_j |a_ij·b_j| and timed over 5 (K6c) or 20 (K6a,
K6b) launches between two CUDA events after a warm-up. With
``--variants``, a tree whose layout has K6c's item table also runs K6c
with item tables cut at 8 and 32 chunks, and two builds of its
``spmv.cu`` changed by text: shared atomics replaced by plain adds (the
sums race, so that build is timed, not checked: what the atomics cost)
and a cap of three blocks an SM at every geometry. One JSON line per
tree, after the card's name and power limit.
"""

import ctypes
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "no_shared_atomics": (
        "atomicAdd(row + ((c + rot) & (W - 1)) * QP, Vec<W>::at(v, c));",
        "row[((c + rot) & (W - 1)) * QP] += Vec<W>::at(v, c);"),
    "three_blocks_an_sm": (
        "__launch_bounds__(kThreads, W * QP >= 64 ? 3 : 4)",
        "__launch_bounds__(kThreads, 3)"),
}


def smoke():
    """This checkout's ``chip_smoke`` (its data recipes and CUDA-event
    timer), loaded by path: a TREE's own ``chip_smoke.py`` may differ. Its
    helpers import ``raft_tpu_torch`` when called, so they use the TREE's
    package."""
    spec = importlib.util.spec_from_file_location(
        "ab_k6_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def within(got, ref, bound) -> bool:
    return bool(((got - ref).abs() <= bound).all())


def build_variant(root: str, name: str, old: str, new: str) -> str:
    from raft_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "spmv.cu")).read()
    if old not in src:
        raise SystemExit(f"ab_k6: variant {name}: text not found")
    out = os.path.join(root, "build", "ab_k6")
    os.makedirs(out, exist_ok=True)
    cu, so = (os.path.join(out, f"{name}.{e}") for e in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    return so


def measure(root: str, variants: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import spmv as k6
    from raft_tpu_torch.sparse import linalg as sl

    cs = smoke()
    cuda_ms = cs.cuda_ms
    res = DeviceResources(device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    n = 1 << 22
    L, _ = sl.laplacian_normalized(res, cs.rmat_adjacency(res, 3, 22))
    T = sl.prepare_spmv(L)
    deg = cs.row_degrees(L)
    T_abs = dataclasses.replace(T, vals=T.vals.abs())
    out = {"tree": root}
    x = torch.randn(n, generator=gen, device="cuda")
    ref = k6.spmv_tiled_ref(T, x)
    bound = (deg + 2) * 2.0 ** -24 * k6.spmv_tiled_ref(T_abs, x.abs())
    out["K6a_ok"] = within(k6.spmv_tiled(T, x), ref, bound)
    out["K6a_ms"] = cuda_ms(lambda: k6.spmv_tiled(T, x), 20)
    del x, ref, bound
    for V in (16, 128):
        B = torch.randn((n, V), generator=gen, device="cuda")
        ref = k6.spmm_tiled_ref(T, B)
        bound = (deg + 2)[:, None] * 2.0 ** -24 * k6.spmm_tiled_ref(
            T_abs, B.abs())
        out[f"K6c_V{V}_ok"] = within(k6.spmm_tiled(T, B), ref, bound)
        out[f"K6c_V{V}_ms"] = cuda_ms(lambda: k6.spmm_tiled(T, B), 5)
        if variants and hasattr(T, "item_chunk0"):
            from raft_tpu_torch.sparse.tiled import spmm_items

            for cap in (8, 32):
                Tc = dataclasses.replace(T, **dict(zip(
                    ("item_chunk0", "item_split", "zero_tiles"),
                    spmm_items(T.chunk_row_tile, T.n_row_tiles, cap))))
                out[f"K6c_V{V}_cap{cap}_ok"] = within(k6.spmm_tiled(Tc, B),
                                                      ref, bound)
                out[f"K6c_V{V}_cap{cap}_ms"] = cuda_ms(
                    lambda: k6.spmm_tiled(Tc, B), 5)
                del Tc
            shipped = _build.load("spmv")
            for name, (old, new) in VARIANTS.items():
                k6._FNS.clear()                  # launch the variant's build
                _build._libs["spmv"] = ctypes.CDLL(
                    build_variant(root, name, old, new))
                Y = k6.spmm_tiled(T, B)
                if name != "no_shared_atomics":
                    out[f"K6c_V{V}_{name}_ok"] = within(Y, ref, bound)
                del Y
                out[f"K6c_V{V}_{name}_ms"] = cuda_ms(
                    lambda: k6.spmm_tiled(T, B), 5)
            k6._FNS.clear()
            _build._libs["spmv"] = shipped
        del B, ref, bound
    del T, T_abs, L
    torch.cuda.empty_cache()
    m = 1 << 20
    band = cs.band_matrix(m, 16, gen)
    TP = sl.prepare_spmv(band, layout="pairs")
    x = torch.randn(m, generator=gen, device="cuda")
    sabs = sl.spmv(None, band.with_values(band.values.abs()), x.abs())
    rnz = cs.row_degrees(band)
    out["K6b_ok"] = within(k6.spmv_pair_tiled(TP, x),
                           k6.spmv_pair_tiled_ref(TP, x),
                           (rnz + 2) * 2.0 ** -24 * sabs)
    out["K6b_ms"] = cuda_ms(lambda: k6.spmv_pair_tiled(TP, x), 20)
    return out


def main() -> int:
    args = sys.argv[1:]
    variants = "--variants" in args
    trees = [a for a in args if a != "--variants"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if os.environ.get("AB_K6_TREE"):
        print(json.dumps(measure(os.environ["AB_K6_TREE"], variants)),
              flush=True)
        return 0
    print(smoke().gpu_name_power(), flush=True)
    for tree in trees:
        env = dict(os.environ, AB_K6_TREE=tree)
        cmd = [sys.executable, os.path.abspath(__file__), *args]
        rc = subprocess.run(cmd, env=env).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
