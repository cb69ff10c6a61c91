"""Package rules of the PyTorch port (raft_tpu_torch): it imports neither
jax nor raft_tpu, its entry points run on the CUDA device unless asked for
the CPU, and the CPU path never launches a kernel."""

import ast
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch import distance
from raft_tpu_torch.ann import (IvfFlatIndex, IvfPqIndex, build_ivf_flat,
                                build_ivf_pq, search_ivf_flat, search_ivf_pq)
from raft_tpu_torch.cluster import kmeans_fit, kmeans_predict
from raft_tpu_torch.core import DeviceError, DeviceResources
from raft_tpu_torch.distance.knn_fused import knn_fused
from raft_tpu_torch.core.sparse_types import COOMatrix
from raft_tpu_torch.models import SpectralEmbedding
from raft_tpu_torch.mutable import MutableIndex, recover
from raft_tpu_torch.ops import fine_scan, fused_l2_topk, pq_scan, sddmm, spmv
from raft_tpu_torch.random import make_blobs, rmat_rectangular_gen
from raft_tpu_torch.runtime import knn_query
from raft_tpu_torch.serving import ServingEngine
from raft_tpu_torch.sparse import linalg as sparse_linalg
from raft_tpu_torch.sparse.solver import (LanczosSolverConfig,
                                          lanczos_compute_eigenpairs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raft_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "raft_tpu")


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import sys, raft_tpu_torch, raft_tpu_torch.distance.knn_fused, "
            "raft_tpu_torch.ann.ivf_flat, raft_tpu_torch.ann.ivf_pq, "
            "raft_tpu_torch.cluster.kmeans, "
            "raft_tpu_torch.mutable, raft_tpu_torch.mutable.layout, "
            "raft_tpu_torch.mutable.index, raft_tpu_torch.mutable.wal, "
            "raft_tpu_torch.mutable.checkpoint, raft_tpu_torch.core.diskio, "
            "raft_tpu_torch.core.serialize, raft_tpu_torch.core.logger, "
            "raft_tpu_torch.resilience.faults, "
            "raft_tpu_torch.observability.costmodel, "
            "raft_tpu_torch.observability.quality, "
            "raft_tpu_torch.ops.fine_scan, raft_tpu_torch.ops.pq_scan, "
            "raft_tpu_torch.ops.spmv, "
            "raft_tpu_torch.ops.sddmm, raft_tpu_torch.sparse.tiled, "
            "raft_tpu_torch.sparse.linalg, raft_tpu_torch.sparse.matrix, "
            "raft_tpu_torch.sparse.solver.lanczos, raft_tpu_torch.spectral, "
            "raft_tpu_torch.models.spectral_embedding, "
            "raft_tpu_torch.random.rmat, raft_tpu_torch.core.bitset, "
            "raft_tpu_torch.core.env, raft_tpu_torch.serving, "
            "raft_tpu_torch.serving.engine, raft_tpu_torch.serving.buckets, "
            "raft_tpu_torch.serving.snapshot, raft_tpu_torch.runtime, "
            "raft_tpu_torch.runtime.entry_points, "
            "raft_tpu_torch.resilience, raft_tpu_torch.resilience.deadline, "
            "raft_tpu_torch.distance.pairwise, raft_tpu_torch.distance.types, "
            "raft_tpu_torch.ops.unexpanded, raft_tpu_torch.ops.histogram, "
            "raft_tpu_torch.stats, raft_tpu_torch.stats.moments, "
            "raft_tpu_torch.stats.histogram, raft_tpu_torch.stats.metrics, "
            "raft_tpu_torch.stats.cluster, raft_tpu_torch.stats.model_select, "
            "raft_tpu_torch.stats.embed, raft_tpu_torch.models.kmeans, "
            "raft_tpu_torch.ops.select_slotted, raft_tpu_torch.ops.folds, "
            "raft_tpu_torch.matrix.select_k_slotted, "
            "raft_tpu_torch.matrix.select_k_chunked, "
            "raft_tpu_torch.matrix.select_k_types, "
            "raft_tpu_torch.matrix.math_ops, raft_tpu_torch.linalg, "
            "raft_tpu_torch.linalg.qr, raft_tpu_torch.linalg.cholesky, "
            "raft_tpu_torch.linalg.eig, raft_tpu_torch.linalg.svd, "
            "raft_tpu_torch.linalg.rsvd, raft_tpu_torch.linalg.lstsq, "
            "raft_tpu_torch.linalg.pca, raft_tpu_torch.linalg.tsvd, "
            "raft_tpu_torch.models.pca, raft_tpu_torch.models.tsvd, "
            "raft_tpu_torch.sparse.solver.cholesky_qr, "
            "raft_tpu_torch.sparse.solver.randomized_svds, "
            "raft_tpu_torch.sparse.solver.mst, "
            "raft_tpu_torch.core.operators, raft_tpu_torch.linalg.map, "
            "raft_tpu_torch.linalg.eltwise, "
            "raft_tpu_torch.linalg.matrix_vector, raft_tpu_torch.linalg.norm, "
            "raft_tpu_torch.linalg.reduce, "
            "raft_tpu_torch.linalg.reduce_by_key, raft_tpu_torch.linalg.blas, "
            "raft_tpu_torch.linalg.transpose, raft_tpu_torch.linalg.init, "
            "raft_tpu_torch.linalg.contractions, raft_tpu_torch.matrix.gather, "
            "raft_tpu_torch.matrix.manip, raft_tpu_torch.label, "
            "raft_tpu_torch.label.classlabels, "
            "raft_tpu_torch.label.merge_labels, "
            "raft_tpu_torch.random.rng_state, raft_tpu_torch.random.rng, "
            "raft_tpu_torch.random.make_regression, "
            "raft_tpu_torch.random.multi_variable_gaussian, "
            "raft_tpu_torch.solver, raft_tpu_torch.solver.linear_assignment, "
            "raft_tpu_torch.ops.lap_jv, raft_tpu_torch.models.knn, "
            "raft_tpu_torch.compat, raft_tpu_torch.compat.pylibraft; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raft_tpu')))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax_and_no_reference():
    bad = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    bad += [(path, a.name) for a in node.names
                            if _forbidden(a.name)]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    if node.level == 0 and _forbidden(node.module):
                        bad.append((path, node.module))
    assert bad == []


def test_ops_export_each_kernel_beside_its_twin():
    """Every kernel wrapper ``raft_tpu_torch.ops`` exports has its plain
    twin (``<name>_ref``) exported beside it; K1's slot forms included."""
    from raft_tpu_torch import ops

    names = set(ops.__all__)
    assert all(hasattr(ops, n) for n in names)
    kernels = {n for n in names if not n.endswith("_ref")} - {
        "fold_group_top2", "split_hi_lo"}
    assert {"fused_l2_slot_topk", "fused_l2_slot_topk_dchunk",
            "fused_l2_group_topk_packed", "select_slot_topk_packed",
            "fine_scan_list_major", "pq_scan_list_major", "spmv_tiled",
            "sddmm_tiled", "unexpanded_pairwise_tiled",
            "histogram_blocked", "lap_jv_solve"} <= kernels
    assert sorted(n for n in kernels if n + "_ref" not in names) == []


def test_entry_points_default_to_cuda():
    y = np.random.default_rng(0).normal(size=(4096, 16)).astype(np.float32)
    if torch.cuda.is_available():
        assert distance.prepare_knn_index(y).device.type == "cuda"
        return
    with pytest.raises(DeviceError):
        distance.prepare_knn_index(y)
    with pytest.raises(DeviceError):
        knn_fused(y[:8], y, 4)
    with pytest.raises(DeviceError):
        DeviceResources()
    with pytest.raises(DeviceError):
        make_blobs(None, 0, 100, 4)
    with pytest.raises(DeviceError):
        distance.knn(None, y, y[:8], 4)
    with pytest.raises(DeviceError):
        kmeans_fit(None, y, 4, max_iter=2)
    with pytest.raises(DeviceError):
        kmeans_predict(None, y[:4], y)
    with pytest.raises(DeviceError):
        build_ivf_flat(None, y, 4, max_iter=2)
    with pytest.raises(DeviceError):
        distance.prepare_knn_index(y, db_dtype="int8")
    with pytest.raises(DeviceError):
        ServingEngine(y, k=4)
    with pytest.raises(DeviceError):
        build_ivf_pq(None, y, 4, pq_bits=4, max_iter=2)
    with pytest.raises(DeviceError):
        ServingEngine(y, k=4, algorithm="ivf_pq", pq_bits=4)
    with pytest.raises(DeviceError):
        MutableIndex(y)
    with pytest.raises(DeviceError):
        ServingEngine(y, k=4, mutable=True)
    with tempfile.TemporaryDirectory() as d:
        MutableIndex(y[:256], device="cpu", durable_dir=d, T=256, g=2,
                     auto_compact=False).close()
        with pytest.raises(DeviceError):
            recover(d, T=256, g=2)
        assert recover(d, device="cpu", T=256, g=2)[0].device.type == "cpu"
    # the same calls on the CPU, by argument
    assert distance.prepare_knn_index(y, device="cpu").device.type == "cpu"
    v, i = knn_fused(y[:8], y, 4, device="cpu")
    assert v.device.type == "cpu" and i.shape == (8, 4)
    X, labels = make_blobs(None, 0, 100, 4, device="cpu")
    assert X.shape == (100, 4) and labels.shape == (100,)
    idx = build_ivf_flat(DeviceResources(device="cpu"), y, 4, max_iter=2)
    assert isinstance(idx, IvfFlatIndex) and idx.device.type == "cpu"
    v, i = search_ivf_flat(None, idx, y[:8], 4, n_probes=2)
    assert v.device.type == "cpu" and i.shape == (8, 4)
    pq = build_ivf_pq(DeviceResources(device="cpu"), y, 4, pq_bits=4,
                      max_iter=2)
    assert isinstance(pq, IvfPqIndex) and pq.device.type == "cpu"
    assert pq.codes.device.type == pq.codebooks.device.type == "cpu"
    v, i = search_ivf_pq(None, pq, y[:8], 4, n_probes=2, pq_scan="pq")
    assert v.device.type == "cpu" and i.shape == (8, 4)
    with pytest.raises(DeviceError):
        search_ivf_pq(DeviceResources(), pq, y[:8], 4)
    q8 = distance.prepare_knn_index(y, db_dtype="int8", device="cpu")
    v, i = knn_query(None, q8, y[:8], 4)
    assert v.device.type == "cpu" and i.shape == (8, 4)
    eng = ServingEngine(y, k=4, device="cpu", buckets=(8,)).start()
    try:
        assert eng.query(y[:3], timeout=30)[1].shape == (3, 4)
    finally:
        eng.stop()


def test_mutable_entry_points_default_to_cuda(tmp_path):
    """MutableIndex and recover build on the card unless asked for the
    CPU (recover over a directory with durable state)."""
    y = np.random.default_rng(1).normal(size=(256, 8)).astype(np.float32)
    d = str(tmp_path / "dur")
    kw = dict(T=256, g=2, auto_compact=False)
    if torch.cuda.is_available():
        assert MutableIndex(y, **kw).device.type == "cuda"
        return
    mi = MutableIndex(y, device="cpu", durable_dir=d, **kw)
    assert mi.device.type == "cpu" and mi.view().base_rv.device.type == "cpu"
    mi.close()
    with pytest.raises(DeviceError):
        MutableIndex(y, **kw)
    with pytest.raises(DeviceError):
        recover(d, **kw)
    r, _ = recover(d, device="cpu", **kw)
    assert r.device.type == "cpu"


def _ring(n=64):
    """A ring graph's symmetric adjacency, held as numpy arrays."""
    r = np.arange(n, dtype=np.int32)
    c = (r + 1) % n
    return COOMatrix(np.concatenate([r, c]), np.concatenate([c, r]),
                     np.ones(2 * n, np.float32), (n, n))


def test_sparse_entry_points_default_to_cuda():
    A = _ring()
    cfg = LanczosSolverConfig(n_components=2, max_iterations=100)
    dense = np.eye(64, dtype=np.float32) + 1.0
    if torch.cuda.is_available():
        assert sparse_linalg.prepare_spmv(A).device.type == "cuda"
        return
    with pytest.raises(DeviceError):
        sparse_linalg.prepare_spmv(A)
    with pytest.raises(DeviceError):
        SpectralEmbedding(n_components=2).fit(A)
    with pytest.raises(DeviceError):
        lanczos_compute_eigenpairs(None, A, cfg)
    with pytest.raises(DeviceError):
        lanczos_compute_eigenpairs(None, dense, cfg)
    with pytest.raises(DeviceError):
        rmat_rectangular_gen(None, 0, 100, 6, 6)
    # the same calls on the CPU, by argument or by handle
    cpu = DeviceResources(device="cpu")
    assert sparse_linalg.prepare_spmv(A, device="cpu").device.type == "cpu"
    m = SpectralEmbedding(n_components=2, res=cpu).fit(A)
    assert m.embedding_.device.type == "cpu"
    assert m.embedding_.shape == (64, 2)
    vals, _ = lanczos_compute_eigenpairs(cpu, dense, cfg)
    assert vals.device.type == "cpu"
    src, _ = rmat_rectangular_gen(None, 0, 100, 6, 6, device="cpu")
    assert src.device.type == "cpu"


def test_cpu_path_launches_no_kernel():
    before = fused_l2_topk.LAUNCHES
    y = torch.randn(4096, 32, generator=torch.Generator().manual_seed(1))
    idx = distance.prepare_knn_index(y, passes=1, T=512, g=8)
    res = DeviceResources(device="cpu")
    v, i = distance.knn(res, idx, y[:16], 5, certify="f32")
    assert torch.equal(i[:, 0], torch.arange(16, dtype=torch.int32))
    assert fused_l2_topk.LAUNCHES == before == 0
    q8 = distance.prepare_knn_index(y, passes=1, T=512, g=8,
                                    db_dtype="int8")
    distance.knn(res, q8, y[:16], 5)
    assert fused_l2_topk.LAUNCHES == fused_l2_topk.LAUNCHES_Q8 == 0
    ivf = build_ivf_flat(res, y, 8, max_iter=2)
    for scan in ("list", "query"):
        search_ivf_flat(res, ivf, y[:16], 5, n_probes=3, fine_scan=scan)
    search_ivf_flat(res, ivf, y[:16], 5, n_probes=8)       # exact plane
    assert fused_l2_topk.LAUNCHES == 0
    assert fine_scan.LAUNCHES == fine_scan.LAUNCHES_Q8 == 0
    for bits in (8, 4):
        pq = build_ivf_pq(res, y, 8, pq_bits=bits, max_iter=2)
        for scan in ("pq", "flat"):
            search_ivf_pq(res, pq, y[:16], 5, n_probes=3, pq_scan=scan)
        search_ivf_pq(res, pq, y[:16], 5, n_probes=8)      # exact plane
    assert pq_scan.LAUNCHES_8BIT == pq_scan.LAUNCHES_4BIT == 0
    assert fused_l2_topk.LAUNCHES == 0
    A = _ring().to("cpu")
    SpectralEmbedding(n_components=2, tiled=True).fit(A)
    t = sparse_linalg.prepare_spmv(A)
    sparse_linalg.spmm(res, t, torch.ones(64, 3))
    sparse_linalg.spmv(res, sparse_linalg.prepare_spmv(A, layout="pairs"),
                       torch.ones(64))
    sparse_linalg.sddmm(res, torch.ones(64, 4), torch.ones(4, 64),
                        sparse_linalg.prepare_sddmm(A))
    assert spmv.LAUNCHES_SPMV == spmv.LAUNCHES_PAIR == spmv.LAUNCHES_SPMM \
        == sddmm.LAUNCHES == 0
    from raft_tpu_torch.mutable import apply_delete, apply_upsert, \
        search_view
    for kw in (dict(T=512, g=8), dict(T=512, g=8, db_dtype="int8"),
               dict(algorithm="ivf_pq", n_lists=8, pq_bits=8)):
        mi = MutableIndex(y, device="cpu", **kw)
        apply_upsert(mi, [9000], y[:1])
        apply_delete(mi, [0])
        search_view(mi, y[:16], 5)
        search_view(mi, y[:16], 5, n_probes=3)
    assert fused_l2_topk.LAUNCHES == fused_l2_topk.LAUNCHES_Q8 == 0
    assert pq_scan.LAUNCHES_8BIT == 0


def test_make_blobs_shapes_and_labels():
    res = DeviceResources(device="cpu", seed=3)
    X, labels, centers = make_blobs(res, 7, 1000, 8, n_clusters=5,
                                    cluster_std=0.5, return_centers=True)
    assert X.shape == (1000, 8) and centers.shape == (5, 8)
    assert torch.bincount(labels.long()).tolist() == [200] * 5
    # every point lies near its own center (std 0.5, 8 features)
    dist = (X - centers[labels.long()]).norm(dim=1)
    assert float(dist.max()) < 0.5 * 8
    X2, _ = make_blobs(res, 7, 1000, 8, n_clusters=5, cluster_std=0.5)
    assert torch.equal(X, X2)                        # seeded
    _, lab = make_blobs(res, 1, 10, 2, n_clusters=3,
                        proportions=[0.5, 0.3, 0.2], shuffle=False)
    assert lab.tolist() == [0] * 5 + [1] * 3 + [2] * 2
    # state=None draws from the handle's seeded generator
    a, _ = make_blobs(DeviceResources(device="cpu", seed=9), None, 50, 3)
    b, _ = make_blobs(DeviceResources(device="cpu", seed=9), None, 50, 3)
    assert torch.equal(a, b)


def test_version():
    assert raft_tpu_torch.__version__


def _mesh_calls():
    from raft_tpu_torch import linalg, models

    return [lambda: models.PCA(2, mesh=object()),
            lambda: models.TruncatedSVD(2, mesh=object()),
            lambda: linalg.pca_fit_distributed(None, None, None, object()),
            lambda: linalg.tsvd_fit_distributed(None, None, None, object()),
            lambda: linalg.pca.pad_mask_shard(None, object())]


@pytest.mark.parametrize("case", range(5))
def test_mesh_options_raise_naming_item_7(case):
    """The multi-device fits are not in the port yet: PCA's and
    TruncatedSVD's ``mesh``, the two distributed fits and the row
    sharding each raise NotImplementedError naming ROADMAP item 7, before
    touching a device."""
    with pytest.raises(NotImplementedError, match="item 7"):
        _mesh_calls()[case]()


def test_dense_linalg_defaults_to_cuda():
    """The new dense entry points run where their tensors lie, or on the
    handle's device for numpy input (cuda by default)."""
    from raft_tpu_torch import linalg, models
    from raft_tpu_torch.sparse import solver

    A = np.random.default_rng(2).normal(size=(40, 6)).astype(np.float32)

    def graph():        # numpy arrays: no device of their own
        return COOMatrix(np.array([0, 1]), np.array([1, 0]),
                         np.array([1.0, 1.0], np.float32), (3, 3))

    if torch.cuda.is_available():
        assert linalg.svd_qr(None, A)[1].device.type == "cuda"
        assert solver.cholesky_qr(A)[0].device.type == "cuda"
        return
    for call in (lambda: linalg.svd_qr(None, A),
                 lambda: linalg.randomized_svd(None, A, 2),
                 lambda: models.PCA(2).fit(A),
                 lambda: solver.randomized_svds(None, graph(),
                                                solver.SvdsConfig(1)),
                 lambda: solver.mst(None, graph()),
                 lambda: solver.cholesky_qr(A),
                 lambda: solver.cholesky_qr2(A)):
        with pytest.raises(DeviceError):
            call()
    assert linalg.svd_qr(None, torch.from_numpy(A))[1].device.type == "cpu"
    assert solver.cholesky_qr(torch.from_numpy(A))[0].device.type == "cpu"
    assert solver.cholesky_qr2(torch.from_numpy(A))[1].device.type == "cpu"
    cpu = DeviceResources(device="cpu")
    assert linalg.randomized_svd(cpu, A, 2)[1].device.type == "cpu"
    assert models.PCA(2, res=cpu).fit(A).components_.device.type == "cpu"
    assert solver.randomized_svds(cpu, graph(), solver.SvdsConfig(1)
                                  )[1].device.type == "cpu"
    assert solver.mst(cpu, graph()).mst.weights.device.type == "cpu"


def test_item13_entry_points_default_to_cuda():
    """The primitive layer, RNG, labels, matrix ops, the LAP,
    NearestNeighbors and the pylibraft surface run on the card unless
    given CPU tensors or a CPU handle, and raise without one."""
    from raft_tpu_torch import compat, label, linalg, matrix, models
    from raft_tpu_torch import random as rnd
    from raft_tpu_torch import solver

    A = np.random.default_rng(3).normal(size=(64, 8)).astype(np.float32)
    labels = np.array([3, 1, 3, 0])
    cost = np.random.default_rng(4).random((6, 6)).astype(np.float32)
    calls = {
        "add": lambda r: linalg.add(r, A, A),
        "reduce": lambda r: linalg.reduce(r, A),
        "row_norm": lambda r: linalg.row_norm(r, A),
        "gemm": lambda r: linalg.gemm(r, A, A.T),
        "reduce_rows_by_key": lambda r: linalg.reduce_rows_by_key(
            r, A, np.arange(64) % 4, 4),
        "range_fill": lambda r: linalg.range_fill(r, 0, 5),
        "tiled_contraction": lambda r: linalg.tiled_contraction(
            r, A, A, lambda ip, x, y: ip),
        "gather": lambda r: matrix.gather(r, A, np.array([1, 2])),
        "eye": lambda r: matrix.eye(r, 3),
        "make_monotonic": lambda r: label.make_monotonic(r, labels)[0],
        "merge_labels": lambda r: label.merge_labels(r, labels % 4,
                                                     labels % 4),
        "uniform": lambda r: rnd.uniform(r, 0, (3,)),
        "pcg_uniform": lambda r: rnd.uniform(
            r, rnd.RngState(1, type=rnd.GeneratorType.PCG), (3,)),
        "normal": lambda r: rnd.normal(r, rnd.RngState(1), (3,)),
        "make_regression": lambda r: rnd.make_regression(r, 0, 20, 3)[0],
        "multi_variable_gaussian": lambda r: rnd.multi_variable_gaussian(
            r, 0, 5, np.zeros(2), np.eye(2)),
        "solve_lap": lambda r: solver.solve_lap(r, cost)[0],
        "nn_fit": lambda r: models.NearestNeighbors(
            n_neighbors=2, res=r).fit(A).kneighbors(A[:2])[1],
        "rmat": lambda r: compat.rmat(10, None, 3, 3, handle=r),
    }
    if torch.cuda.is_available():
        for call in calls.values():
            assert call(None).device.type == "cuda"
        return
    cpu = DeviceResources(device="cpu")
    for name, call in calls.items():
        with pytest.raises(DeviceError):
            call(None)
        assert call(cpu).device.type == "cpu", name
    # CPU tensors stay on the CPU without a handle
    t = torch.from_numpy(A)
    assert linalg.add(None, t, t).device.type == "cpu"
    assert linalg.reduce(None, t).device.type == "cpu"
    assert matrix.gather(None, t, torch.tensor([0])).device.type == "cpu"
    assert solver.solve_lap(None, torch.from_numpy(cost))[0].device.type \
        == "cpu"
    nn = models.NearestNeighbors(n_neighbors=2).fit(t)
    assert nn.kneighbors(t[:2])[1].device.type == "cpu"
    with pytest.raises(DeviceError):
        compat.device_ndarray(A)
    with pytest.raises(DeviceError):
        compat.eigsh(compat.device_ndarray(A[:8] @ A[:8].T, device="cpu"),
                     k=2)
