"""The port's spans and fault sites against the reference's, statically
and on the CPU.

The static half is the port's counterpart of the reference repository's
``tools/check_instrumented.py``: both packages are parsed with ``ast``
(the reference is not imported) and

- the port's ``@instrument`` names are the reference's, less ``tune.*``
  (the TPU tuners, not ported);
- the port's ``fault_point`` sites are the reference's, less the five
  of unported modules, each named with its reason;
- every site the port calls is in its ``KNOWN_SITES``, which holds the
  reference's kinds for each of its 37 entries.

The fault matrix arms each of those sites (``error`` at its first
call) on a small CPU call: the injected error surfaces and the counter
rises by one, and disarmed the call answers as before. Three sites
diverge from the reference by design, and the matrix names them: at
``fine_scan_list``, ``pq_scan`` and ``pq_widen`` the reference degrades
to another schedule and answers; the port raises (no fallback hides a
kernel).
"""

import ast
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: sites of unported modules, with the reason each is absent
EXCLUDED_SITES = {
    "autotune_fused": "tune/fused.py: the TPU tuner (K1's geometry is "
                      "picked in C on the card)",
    "autotune_sharded": "tune/sharded.py: the TPU tuner",
    "autotune_fine_scan": "tune/ivf.py: the TPU tuner",
    "tune_table_read": "the TPU tune tables, which the port never reads",
    "plan_cache_read": "sparse/plan_cache.py: the layout plan cache "
                       "(ROADMAP item 12)",
}

#: the sites beyond serving, mutation and the sharded merge
NEW_SITES = (
    "aot_compile", "aot_dispatch", "knn_fused", "quantize_index",
    "select_k", "select_k_chunked", "select_k_slotted", "pairwise_distance",
    "fused_l2nn", "tile_csr", "solve_lap", "kmeans_fit", "kmeans_iteration",
    "ivf_build", "ivf_search", "fine_scan_list", "pq_train", "pq_scan",
    "opq_train", "pq_widen")


@pytest.fixture(autouse=True)
def clean_planes():
    obs.reset()
    faults.clear()
    yield
    obs.reset()
    faults.clear()


def _py_files(pkg):
    root = os.path.join(REPO, pkg)
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _strings(node):
    """The string constants an argument can take (a literal or the arms
    of a conditional expression)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.IfExp):
        return _strings(node.body) + _strings(node.orelse)
    return []


def _scan(pkg):
    """({span names of @instrument}, {fault_point sites}) of a package."""
    spans, sites = set(), set()
    for path in _py_files(pkg):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if (isinstance(dec, ast.Call)
                            and getattr(dec.func, "id",
                                        getattr(dec.func, "attr", ""))
                            == "instrument" and dec.args):
                        spans.update(_strings(dec.args[0]))
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", ""))
                    == "fault_point" and node.args):
                sites.update(_strings(node.args[0]))
    return spans, sites


def _known_sites(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if (isinstance(node, ast.AnnAssign)
                and getattr(node.target, "id", "") == "KNOWN_SITES"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no KNOWN_SITES in {path}")


REF_SPANS, REF_SITES = _scan("raft_tpu")
PORT_SPANS, PORT_SITES = _scan("raft_tpu_torch")
REF_KNOWN = _known_sites(os.path.join(REPO, "raft_tpu", "resilience",
                                      "faults.py"))
PORT_KNOWN = _known_sites(os.path.join(REPO, "raft_tpu_torch", "resilience",
                                       "faults.py"))


def test_instrument_names_are_the_references_less_tune():
    want = {s for s in REF_SPANS if not s.startswith("tune.")}
    assert PORT_SPANS == want
    assert len(PORT_SPANS) == 26


def test_fault_sites_are_the_references_less_the_excluded():
    assert REF_SITES - PORT_SITES == set(EXCLUDED_SITES)
    assert PORT_SITES <= REF_SITES
    assert set(NEW_SITES) <= PORT_SITES


def test_known_sites_hold_every_called_site_with_the_reference_kinds():
    assert PORT_SITES <= set(PORT_KNOWN)
    assert len(PORT_KNOWN) == 37
    assert set(REF_KNOWN) - set(PORT_KNOWN) == set(EXCLUDED_SITES)
    for site, kinds in PORT_KNOWN.items():
        assert REF_KNOWN[site] == kinds, site
    # the table the code reads is the one parsed here
    assert faults.KNOWN_SITES == PORT_KNOWN


# ------------------------------------------------------------------
# the fault matrix on the CPU
# ------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    from raft_tpu_torch import DeviceResources, distance
    from raft_tpu_torch.ann import build_ivf_flat, build_ivf_pq
    from raft_tpu_torch.core.sparse_types import CSRMatrix

    rng = np.random.default_rng(5)
    Y = rng.normal(size=(3000, 32)).astype(np.float32)
    Q = (Y[:16] + 0.01 * rng.normal(size=(16, 32))).astype(np.float32)
    dense = (rng.random((512, 512)) < 0.01) * rng.normal(size=(512, 512))
    res = DeviceResources(device="cpu", seed=0)
    return {
        "res": res, "Y": torch.from_numpy(Y), "Q": torch.from_numpy(Q),
        "Y_np": Y, "Q_np": Q,
        "V": torch.from_numpy(rng.normal(size=(8, 4096)).astype(np.float32)),
        "C": torch.from_numpy(rng.random((48, 48)).astype(np.float32)),
        "A": CSRMatrix.from_dense(dense.astype(np.float32), device="cpu"),
        "x6": torch.from_numpy(rng.normal(size=512).astype(np.float32)),
        "idx": distance.prepare_knn_index(torch.from_numpy(Y), passes=3,
                                          T=256),
        "ivf": build_ivf_flat(res, torch.from_numpy(Y), n_lists=16),
        "pq": build_ivf_pq(res, torch.from_numpy(Y), n_lists=16, pq_bits=8),
    }


def _calls(s):
    from raft_tpu_torch import distance
    from raft_tpu_torch.ann import (build_ivf_flat, build_ivf_pq,
                                    search_ivf_flat, search_ivf_pq)
    from raft_tpu_torch.cluster import kmeans_fit
    from raft_tpu_torch.distance.knn_fused import knn_fused
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.matrix.select_k_chunked import select_k_chunked
    from raft_tpu_torch.matrix.select_k_slotted import select_k_slotted
    from raft_tpu_torch.ops import spmv as k6
    from raft_tpu_torch.runtime.entry_points import knn_query
    from raft_tpu_torch.solver import solve_lap
    from raft_tpu_torch.sparse.tiled import tile_csr

    res, Y, Q = s["res"], s["Y"], s["Q"]
    return {
        "aot_dispatch": lambda: knn_query(res, s["idx"], Q, 5),
        "knn_fused": lambda: knn_fused(Q, s["idx"], 5),
        "quantize_index": lambda: knn_fused(Q, distance.prepare_knn_index(
            Y, passes=1, db_dtype="int8", T=256), 5),
        "select_k": lambda: select_k(res, s["V"], k=8),
        "select_k_chunked": lambda: select_k_chunked(s["V"], None, 8, True),
        "select_k_slotted": lambda: select_k_slotted(s["V"], None, 8, True),
        "pairwise_distance": lambda: distance.pairwise_distance(
            res, Q, Y[:256], metric="l1"),
        "fused_l2nn": lambda: distance.fused_l2_nn_argmin(res, Q, Y),
        "tile_csr": lambda: k6.spmv_tiled(tile_csr(s["A"]), s["x6"]),
        "solve_lap": lambda: solve_lap(res, s["C"])[::-1],  # (cost, rows)
        "kmeans_fit": lambda: kmeans_fit(res, Y[:1024], 4, seed=0).labels,
        "kmeans_iteration": lambda: kmeans_fit(res, Y[:1024], 4,
                                               seed=0).labels,
        "ivf_build": lambda: search_ivf_flat(
            res, build_ivf_flat(res, Y, n_lists=16), Q, 5, n_probes=4),
        "ivf_search": lambda: search_ivf_flat(res, s["ivf"], Q, 5,
                                              n_probes=4),
        "fine_scan_list": lambda: search_ivf_flat(
            res, s["ivf"], Q, 5, n_probes=4, fine_scan="list"),
        "pq_train": lambda: search_ivf_pq(
            res, build_ivf_pq(res, Y, n_lists=16, pq_bits=8), Q, 5,
            n_probes=4),
        "pq_scan": lambda: search_ivf_pq(res, s["pq"], Q, 5, n_probes=4,
                                         pq_scan="pq"),
        "opq_train": lambda: search_ivf_pq(
            res, build_ivf_pq(res, Y, n_lists=16, pq_bits=8,
                              pq_mode="opq"), Q, 5, n_probes=4),
        "pq_widen": lambda: search_ivf_pq(res, s["pq"], Q, 5, n_probes=4,
                                          pq_scan="pq"),
    }


def _answer(out):
    return out[1] if isinstance(out, tuple) else out


def _injections(site):
    reg = obs.get_registry()
    for m in reg.collect():
        if (m.name == faults.INJECTIONS and m.labels.get("site") == site
                and m.labels.get("kind") == "error"):
            return m.value
    return 0


@pytest.mark.parametrize("site", [s for s in NEW_SITES
                                  if s != "aot_compile"])
def test_fault_matrix_raises_then_answers_as_before(small, site,
                                                    monkeypatch):
    from raft_tpu_torch.ann import ivf_pq

    if site == "pq_widen":
        # every query fails the depth-2 certificate, so the widen rung runs
        monkeypatch.setattr(ivf_pq, "_pq_certify",
                            lambda b, t, w: torch.zeros_like(b >= t + w))
    call = _calls(small)[site]
    before = _answer(call())
    faults.configure(f"{site}:error@call=1")
    with pytest.raises(faults.InjectedDeviceError):
        call()
    faults.clear()
    assert _injections(site) == 1
    assert torch.equal(before, _answer(call()))


def test_aot_compile_fires_on_a_library_cache_miss(tmp_path, monkeypatch):
    """``aot_compile`` sits at ``ops/_build.py``'s build on a cache miss,
    before ``nvcc`` runs; a library already built (a hit) passes it by."""
    from raft_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    faults.configure("aot_compile:error@call=1")
    with pytest.raises(faults.InjectedDeviceError):
        _build.build("lap_jv")
    assert _injections("aot_compile") == 1
    hit = _build.library_path("lap_jv")
    os.makedirs(os.path.dirname(hit), exist_ok=True)
    open(hit, "wb").close()                 # a built library: a cache hit
    faults.configure("aot_compile:error@call=1")
    assert _build.build("lap_jv") == hit
    reg = obs.get_registry()
    hits = [m.value for m in reg.collect()
            if m.name == "raft_tpu_compile_cache_hits_total"]
    assert hits == [1.0]


@pytest.mark.parametrize("site", ["fine_scan_list", "pq_scan", "pq_widen"])
def test_divergence_reference_degrades_where_the_port_raises(small, site,
                                                             monkeypatch):
    """The reference catches a failure at these three sites and answers
    through another schedule (a ``degradation`` record); the port raises
    it to the caller."""
    import raft_tpu.ann.ivf_pq as jivf_pq
    from raft_tpu import DeviceResources as JRes
    from raft_tpu.ann import build_ivf_flat as jbuild_flat
    from raft_tpu.ann import build_ivf_pq as jbuild_pq
    from raft_tpu.ann import search_ivf_flat as jsearch_flat
    from raft_tpu.ann import search_ivf_pq as jsearch_pq
    from raft_tpu.resilience import faults as jfaults
    from raft_tpu.resilience.policy import degradation_count
    from raft_tpu_torch.ann import ivf_pq

    jres = JRes(seed=0)
    Y, Q = small["Y_np"], small["Q_np"]
    if site == "fine_scan_list":
        jidx = jbuild_flat(jres, Y, n_lists=16)

        def jcall():
            return jsearch_flat(jres, jidx, Q, 5, n_probes=4,
                                fine_scan="list")
    else:
        jidx = jbuild_pq(jres, Y, n_lists=16, pq_bits=8)
        if site == "pq_widen":
            monkeypatch.setattr(jivf_pq, "_pq_certify",
                                lambda b, t, w: b < -np.inf)
            monkeypatch.setattr(ivf_pq, "_pq_certify",
                                lambda b, t, w: torch.zeros_like(b >= t + w))

        def jcall():
            return jsearch_pq(jres, jidx, Q, 5, n_probes=4, pq_scan="pq")
    n0 = degradation_count()
    jfaults.configure(f"{site}:error@call=1")
    try:
        _, ids = jcall()                    # the reference degrades
    finally:
        jfaults.clear()
    assert np.asarray(ids).shape == (16, 5)
    assert degradation_count() == n0 + 1
    faults.configure(f"{site}:error@call=1")
    with pytest.raises(faults.InjectedDeviceError):
        _calls(small)[site]()               # the port raises
