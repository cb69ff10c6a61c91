"""IVF-PQ: the product-quantized tier over the IVF-Flat slab.

Counterpart of ``raft_tpu/ann/ivf_pq.py`` (ref: neighbors/ivf_pq.cuh and
cuVS ``ivf_pq::build/search`` with its refine step).

Index (:class:`IvfPqIndex`, built by :func:`build_ivf_pq`): the IVF-Flat
padded ragged slab unchanged (its f32 rows stay as the exact-rescore
plane), plus the compressed sidecar on the same rows:

- ``pq_dim`` subspaces of width ``d / pq_dim``, each with a codebook of
  ``2^pq_bits`` codewords trained by :func:`~raft_tpu_torch.cluster.
  kmeans_fit` on residuals to the coarse centroid (cuVS ``by_residual``);
- the codes slab ``[R, pq_dim]`` (8-bit, stored biased) or
  ``[R, pq_dim/2]`` (4-bit, two codes per byte), the reconstructed norms
  ``‖ŷ‖²`` and the recorded per-row round-trip bounds ``pq_eq_rows``, with
  their per-subspace and per-list roll-ups.

``pq_mode="opq"`` learns an orthogonal rotation first (OPQ alternating
minimization), ``"opq_aniso"`` also assigns codewords under the
score-aware anisotropic loss. The build runs on the index's device in
torch (the reference sweeps the encode on the host in numpy); the
rotation's SVD runs in f64.

Search (:func:`search_ivf_pq`): coarse probe → the list-major schedule
(``build_list_schedule``) → the ADC kernel K5 (:mod:`raft_tpu_torch.ops.
pq_scan`) over the codes, pooling each row's certified lower bound
``(max(√d2_adc − Eq_row, 0))²`` → the pooled candidates exact-rescored
from the f32 slab → a per-query completeness certificate. Failures climb
the reference's three-rung ladder: certified as is, then the widen rung
(the ADC re-run with a 512- and a 1024-slot pool, up to
``RAFT_TPU_ANN_PQ_WIDEN``), then the exact f32 rerun of the queries still
failing. Returned id sets equal the flat scan's over the same probes.
``n_probes ≥ n_lists`` (or ``k`` past the probed capacity) is IVF-Flat's
exact plane (K1). The ADC scan runs on whole batches, query-chunked only
to keep its buffers under :data:`_PQ_BUDGET` (pools are per query, so the
chunking changes no id); the reference's 8-query chunk stays only for the
query-major rerun. Every answer is rescored one row-wise dot a candidate
(the exact scan's batched product only nominates k + 32 candidates), so
it does not depend on the batch or the rung it took: a served request
equals the query asked alone.

No fallback hides the kernel: the reference catches any exception of the
ADC scan and of the widen rung and degrades to the flat scan
(``ivf_pq.py:860-875, 938-955``); here a K5 build or launch failure
raises to the caller.

The ladder feeds the quality counters and, under an active explain
capture, the explain record (plane, probes, schedule, margins, rungs).
The reference has no sharded IVF-PQ index (its ``ShardedIvfIndex`` is
IVF-Flat only), so neither has the port. ``build_ivf_pq`` and
``search_ivf_pq`` are spans, and the reference's fault sites
``pq_train``, ``opq_train``, ``ivf_search``, ``pq_scan`` and ``pq_widen``
sit where the reference has them; the last two raise where the
reference degrades. Left out of this slice: the mutable plane's
tombstoned codes and the TPU tune table's ``pq`` column.
The reference's ``RAFT_TPU_ANN_NPROBES`` knob is the plain ``n_probes``
argument here, as in the port's IVF-Flat.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.ann.ivf_flat import (
    _FINE_TILE, _LIST_K_MAX, DEFAULT_ROW_QUANTUM, IvfFlatIndex,
    _coarse_probe, _exact_search, _list_host, _pad_kernel_operands,
    _pool_finish, _query_major, build_ivf_flat, build_list_schedule,
    exact_reason, probe_notes, require_finite_rows)
from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import (DeviceResources, as_f32,
                                           ensure_resources)
from raft_tpu_torch.observability import explain
from raft_tpu_torch.observability.quality import (record_certificate,
                                                  record_pq_rungs)
from raft_tpu_torch.ops.fine_scan import LISTS_PER_CELL, pad_window
from raft_tpu_torch.ops.pq_scan import (MAX_SMEM_BYTES, decode_codes,
                                        pq_scan_list_major,
                                        pq_scan_smem_bytes)
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point

_log = logging.getLogger(__name__)

#: PQ schedules: "pq" = the ADC kernel over the codes slab, "flat" = the
#: uncompressed query-major scan, "auto" = the cost-model crossover
#: (:func:`resolve_pq_scan`). Env: RAFT_TPU_IVF_PQ_SCAN.
PQ_SCANS = ("auto", "pq", "flat")

#: quantizer modes (env default RAFT_TPU_ANN_PQ_MODE)
PQ_MODES = ("plain", "opq", "opq_aniso")

#: anisotropic assignment weight: the residual error parallel to the data
#: point costs this much more than the orthogonal one (ScaNN, fixed η)
_PQ_ANISO_ETA = 4.0

#: multiplicative headroom on every recorded f32 error bound (the f32
#: rounding between the recorded and the true round-trip error)
_PQ_EQ_HEADROOM = 1.0 + 2.0 ** -10
#: additive headroom, scaled by the row or subspace magnitude: a row whose
#: residual is exactly a codeword records 0 while the reconstruction still
#: carries f32 representation error
_PQ_EQ_ABS = 2.0 ** -16

#: bytes one ADC call's per-query buffers may hold (the table, the
#: centroid dots, the pools and the pool rescore's gathers): larger
#: batches are query-chunked to it
_PQ_BUDGET = 1 << 30

#: certificate counters' call site (observability.quality)
_SITE = "ann.search_ivf_pq"


def _default_pq_dim(d: int) -> int:
    """Largest divisor of ``d`` not above ``d // 4``: about 4 features a
    subspace (16× at 8-bit codes), tiling the width exactly."""
    for cand in range(max(1, d // 4), 0, -1):
        if d % cand == 0:
            return cand
    return 1


def pack_pq_codes(codes, pq_bits: int) -> torch.Tensor:
    """[R, S] codes (tensor or numpy) packed as the kernel reads them:
    8-bit codes stored biased (code − 128) as int8, 4-bit codes two to a
    byte (low nibble = even subspace)."""
    codes = torch.as_tensor(codes).long()
    if pq_bits == 8:
        return (codes - 128).to(torch.int8)
    expects(codes.shape[1] % 2 == 0,
            "pack_pq_codes: 4-bit packing needs an even pq_dim")
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8) \
        .view(torch.int8)


def unpack_pq_codes(packed, pq_dim: int, pq_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_pq_codes`: [R, pq_dim] int64 codes."""
    return decode_codes(torch.as_tensor(packed), pq_dim, pq_bits)


class IvfPqIndex(IvfFlatIndex):
    """An IVF-Flat index plus the product-quantized sidecar (see the module
    doc). It is an :class:`IvfFlatIndex`: every flat plane (the exact
    search, the layout, the schedule builder) works on it."""

    def __init__(self, flat: IvfFlatIndex, *, pq_dim: int, pq_bits: int,
                 codebooks, codes, yy_pq, pq_eq_rows, pq_eq_sub, pq_eq_list,
                 pq_rhat_list, pq_mode: str = "plain", pq_rot=None,
                 pq_eq_qlist=None, pq_resid_med: float = 0.0):
        self.__dict__.update(vars(flat))
        self.pq_dim = int(pq_dim)            # subspace count S
        self.pq_bits = int(pq_bits)          # 4 or 8
        self.codebooks = codebooks           # [S, K, dsub] f32
        self.codes = codes                   # [R, S or S/2] int8 packed
        self.yy_pq = yy_pq                   # [R, 1] f32 ‖ŷ‖² (pads 0)
        self.pq_eq_rows = pq_eq_rows         # [R] f32 ‖y − ŷ‖ bound
        self.pq_eq_sub = pq_eq_sub           # [S] numpy subspace envelope
        self.pq_eq_list = pq_eq_list         # [L] f32 per-list max
        self.pq_rhat_list = pq_rhat_list     # [L] f32 max ‖r̂‖ per list
        self.pq_mode = str(pq_mode)          # plain | opq | opq_aniso
        self.pq_rot = pq_rot                 # [d, d] f32 or None
        self.pq_eq_qlist = pq_eq_qlist       # [L, 3] numpy q50/q90/max
        self.pq_resid_med = float(pq_resid_med)  # median ‖y − c‖
        # host-clock seconds of the build's stages (build_ivf_pq only)
        self.build_seconds = None

    @property
    def dsub(self) -> int:
        return self.d_orig // self.pq_dim

    @property
    def pq_k(self) -> int:
        return 1 << self.pq_bits

    @property
    def code_bytes(self) -> int:
        """Streamed code bytes per row."""
        return self.pq_dim if self.pq_bits == 8 else self.pq_dim // 2

    def __repr__(self):
        return (f"IvfPqIndex(n_rows={self.n_rows}, n_lists={self.n_lists}, "
                f"d={self.d_orig}, pq_dim={self.pq_dim}, "
                f"pq_bits={self.pq_bits}, pq_mode={self.pq_mode}, "
                f"window={self.probe_window})")

    def layout(self):
        """The shared :class:`~raft_tpu_torch.mutable.layout.IndexLayout`
        with the PQ sidecar on the slab's rows."""
        lay = super().layout()
        lay.pq_codes = self.codes
        lay.pq_yy = self.yy_pq
        lay.pq_eq_rows = self.pq_eq_rows
        lay.pq_rot = self.pq_rot
        lay.pq_meta = {"pq_dim": self.pq_dim, "pq_bits": self.pq_bits,
                       "pq_mode": self.pq_mode, "codebooks": self.codebooks}
        return lay

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "IvfPqIndex":
        """The port's index from a reference ``IvfPqIndex``'s state as
        numpy: :meth:`IvfFlatIndex.from_numpy`'s arrays plus ``pq_dim,
        pq_bits, pq_mode, codebooks, codes, yy_pq, pq_eq_rows, pq_eq_sub,
        pq_eq_list, pq_rhat_list, pq_eq_qlist, pq_rot`` (or None) and
        ``pq_resid_med``. Both packages then search the same index."""
        flat = IvfFlatIndex.from_numpy(arrays, device)
        dev = flat.device

        def f32(name):
            a = arrays.get(name)
            return None if a is None else as_f32(np.asarray(a), dev)

        R = flat.slab_rows
        codes = torch.from_numpy(np.array(arrays["codes"], np.int8)).to(dev)
        return cls(
            flat, pq_dim=int(arrays["pq_dim"]),
            pq_bits=int(arrays["pq_bits"]), codebooks=f32("codebooks"),
            codes=codes, yy_pq=f32("yy_pq").reshape(R, 1),
            pq_eq_rows=f32("pq_eq_rows").reshape(R),
            pq_eq_sub=np.asarray(arrays["pq_eq_sub"], np.float32),
            pq_eq_list=f32("pq_eq_list"), pq_rhat_list=f32("pq_rhat_list"),
            pq_mode=str(arrays.get("pq_mode", "plain")), pq_rot=f32("pq_rot"),
            pq_eq_qlist=np.asarray(arrays["pq_eq_qlist"], np.float32),
            pq_resid_med=float(arrays.get("pq_resid_med", 0.0)))


# ------------------------------------------------------------------ build
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _opq_rotation(res, train, S: int, dsub: int, K: int, seed: int,
                  n_iters: int = 3, train_iters: int = 3):
    """OPQ alternating minimization over the residual train sample
    (reference ``:230``): codebooks → encode → orthogonal Procrustes (the
    SVD of ``trainᵀ · recon``, in f64) → codebooks re-trained on the
    re-rotated residuals, warm-started. Returns (rotation [d, d] f32, the
    warm per-subspace codebooks)."""
    from raft_tpu_torch.cluster import kmeans_fit, kmeans_predict

    d = train.shape[1]
    rot = torch.eye(d, device=train.device)
    cbs = [None] * S
    for _ in range(max(1, int(n_iters))):
        tr = train @ rot
        recon = torch.empty_like(tr)
        for s in range(S):
            sub = tr[:, s * dsub:(s + 1) * dsub]
            km = kmeans_fit(res, sub, K, max_iter=train_iters,
                            seed=seed + 211 + s, balanced=False,
                            init_centroids=cbs[s])
            cbs[s] = km.centroids
            code = kmeans_predict(res, km.centroids, sub)
            recon[:, s * dsub:(s + 1) * dsub] = cbs[s][code.long()]
        u, _, vt = torch.linalg.svd(train.double().T @ recon.double())
        rot = (u @ vt).float()
    return rot, cbs


def _aniso_assign(sub, cb, eta: float = _PQ_ANISO_ETA):
    """Score-aware codeword assignment for one subspace (reference
    ``:263``): ``argmin_c ‖r − c‖² + (η − 1)·((r − c)·r/‖r‖)²``, the
    error parallel to the residual costing η× the orthogonal one. Chunked
    [rows × K] sweep on the rows' device."""
    n = sub.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=sub.device)
    cc = (cb * cb).sum(1)
    step = 65536
    for s0 in range(0, n, step):
        r = sub[s0:s0 + step]
        rn2 = (r * r).sum(1, keepdim=True)
        rn = rn2.sqrt()
        rc = r @ cb.T
        base = rn2 + cc[None, :] - 2.0 * rc
        par = (rn - rc / rn.clamp_min(1e-30)) ** 2
        par = torch.where(rn > 0.0, par, 0.0)
        out[s0:s0 + step] = torch.argmin(base + (eta - 1.0) * par, dim=1)
    return out


def _train_codebooks(res, flat: IvfFlatIndex, S: int, K: int,
                     pq_max_iter: int, seed: int,
                     pq_train_rows: Optional[int], pq_mode: str,
                     opq_iters: int):
    """The rotation (None for plain PQ) and the [S, K, dsub] codebooks,
    trained on a residual sample of at most ``pq_train_rows`` valid rows
    (default ``max(32·K, 4096)``, drawn with numpy's
    ``default_rng(seed + 17)`` as the reference draws them)."""
    from raft_tpu_torch.cluster import kmeans_fit
    from raft_tpu_torch.mutable.layout import list_of_rows

    dev, d = flat.device, flat.d_orig
    dsub = d // S
    fault_point("pq_train")
    vrows = np.nonzero((flat.ids >= 0).cpu().numpy())[0]
    n_valid = int(vrows.size)
    cap = pq_train_rows or max(32 * K, 4096)
    if n_valid > cap:
        vrows = np.random.default_rng(seed + 17).choice(vrows, cap,
                                                        replace=False)
    expects(vrows.size >= K, "build_ivf_pq: %d valid rows < %d codewords",
            n_valid, K)
    sel = torch.from_numpy(vrows).to(dev)
    gid = list_of_rows(flat.layout())
    train = flat.slab[sel] - flat.centroids[gid[sel]]
    rot, warm = None, [None] * S
    if pq_mode != "plain":
        fault_point("opq_train")
        rot, warm = _opq_rotation(res, train, S, dsub, K, seed,
                                  n_iters=opq_iters,
                                  train_iters=max(1, pq_max_iter // 2))
        train = train @ rot
    books = train.new_empty((S, K, dsub))
    for s in range(S):
        km = kmeans_fit(res, train[:, s * dsub:(s + 1) * dsub], K,
                        max_iter=pq_max_iter, seed=seed + 101 + s,
                        balanced=False, init_centroids=warm[s])
        books[s] = km.centroids
    return rot, books


def _list_quantiles(v, gid, valid, L: int, qs=(0.5, 0.9, 1.0)):
    """[L, len(qs)] f32 quantiles of ``v`` over each list's valid rows
    (0 for a list without one), numpy's ``linear`` rule in f64."""
    gv, vv = gid[valid], v[valid].double()
    order = torch.argsort(vv, stable=True)
    order = order[torch.argsort(gv[order], stable=True)]
    sv = vv[order]
    counts = torch.bincount(gv, minlength=L)
    first = torch.cumsum(counts, 0) - counts
    live = counts > 0
    out = torch.zeros((L, len(qs)), dtype=torch.float64, device=v.device)
    if not sv.numel():
        return out.float()
    top = (counts - 1).clamp_min(0)
    for c, q in enumerate(qs):
        pos = q * top.double()
        lo = pos.floor().long()
        hi = torch.minimum(lo + 1, top)
        t = pos - lo.double()
        a = sv[(first + lo).clamp_max(sv.numel() - 1)]
        b = sv[(first + hi).clamp_max(sv.numel() - 1)]
        diff = b - a
        val = torch.where(t >= 0.5, b - diff * (1.0 - t), a + diff * t)
        out[:, c] = torch.where(live, val, 0.0)
    return out.float()


def _pq_encode(res, flat: IvfFlatIndex, codebooks, rot, pq_bits: int,
               pq_mode: str) -> dict:
    """Encode the slab's residuals with given codebooks [S, K, dsub] and
    rotation (None for plain PQ), and record the error envelopes (reference
    ``:412-476``): ``pq_eq_sub`` (per subspace), ``pq_eq_rows`` (per row,
    the certificate's sidecar), ``pq_eq_list`` / ``pq_rhat_list`` (per-list
    max of the row bound and of ‖r̂‖), the per-list quantile sketch
    ``pq_eq_qlist``, the median residual norm and ``yy_pq``. Returns the
    :class:`IvfPqIndex` keyword arguments of the sidecar."""
    from raft_tpu_torch.cluster import kmeans_predict
    from raft_tpu_torch.mutable.layout import list_of_rows

    S, K, dsub = codebooks.shape
    slab, L = flat.slab, flat.n_lists
    R, d = slab.shape
    gid = list_of_rows(flat.layout())
    valid = flat.ids >= 0
    vf = valid.float()
    cg = flat.centroids[gid]
    resid = slab - cg
    enc = resid if rot is None else resid @ rot
    codes = torch.empty((R, S), dtype=torch.int64, device=slab.device)
    for s in range(S):
        sub = enc[:, s * dsub:(s + 1) * dsub]
        codes[:, s] = (_aniso_assign(sub, codebooks[s])
                       if pq_mode == "opq_aniso" else
                       kmeans_predict(res, codebooks[s], sub).long())
    del enc
    # with a rotation the codes encode r·R, so ŷ = c + r̂'·Rᵀ: norms are
    # preserved and every envelope is taken on the actual reconstruction
    rhat = codebooks[torch.arange(S, device=slab.device)[None, :], codes] \
        .reshape(R, d)
    if rot is not None:
        rhat = rhat @ rot.T
    recon = cg + rhat
    del cg
    err = (slab - recon) * vf[:, None]
    mag_sub = ((slab.reshape(R, S, dsub) ** 2).sum(2).sqrt()
               + (recon.reshape(R, S, dsub) ** 2).sum(2).sqrt()) \
        * vf[:, None]
    mag_row = ((slab ** 2).sum(1).sqrt() + (recon ** 2).sum(1).sqrt()) * vf
    e_sub = (err.reshape(R, S, dsub) ** 2).sum(2).clamp_min(0.0).sqrt()
    if R:
        eq_sub = (e_sub.max(0).values * _PQ_EQ_HEADROOM
                  + _PQ_EQ_ABS * mag_sub.max(0).values)
    else:
        eq_sub = slab.new_zeros(S)
    eq_rows = ((err ** 2).sum(1).clamp_min(0.0).sqrt() * _PQ_EQ_HEADROOM
               + _PQ_EQ_ABS * mag_row)
    rhat = recon - flat.centroids[gid]
    rhat_norm = (rhat * rhat).sum(1).clamp_min(0.0).sqrt() * vf
    eq_list = slab.new_zeros(L).scatter_reduce(0, gid, eq_rows, "amax")
    rhat_list = slab.new_zeros(L).scatter_reduce(0, gid, rhat_norm, "amax")
    resid_norm = (resid * resid).sum(1).clamp_min(0.0).sqrt()[valid]
    resid_med = 0.0
    if resid_norm.numel():
        srt = torch.sort(resid_norm.double()).values
        n = srt.numel()
        resid_med = float(srt[n // 2] if n % 2
                          else (srt[n // 2 - 1] + srt[n // 2]) / 2.0)
    return dict(
        codes=pack_pq_codes(codes, pq_bits).to(slab.device),
        yy_pq=torch.where(valid, (recon * recon).sum(1), 0.0).reshape(R, 1),
        pq_eq_rows=eq_rows, pq_eq_sub=eq_sub.cpu().numpy(),
        pq_eq_list=eq_list, pq_rhat_list=rhat_list,
        pq_eq_qlist=_list_quantiles(eq_rows, gid, valid, L).cpu().numpy(),
        pq_resid_med=resid_med)


@instrument("ann.build_ivf_pq")
def build_ivf_pq(res, y, n_lists: int, pq_dim: Optional[int] = None,
                 pq_bits: Optional[int] = None,
                 n_probes: Optional[int] = None, max_iter: int = 10,
                 pq_max_iter: int = 8, seed: int = 0,
                 balanced: bool = True,
                 row_quantum: int = DEFAULT_ROW_QUANTUM,
                 max_train_rows: Optional[int] = None,
                 pq_train_rows: Optional[int] = None,
                 pq_mode: Optional[str] = None,
                 opq_iters: int = 3) -> IvfPqIndex:
    """Build an :class:`IvfPqIndex` over ``y`` [m, d] (numpy, or a tensor
    whose device the index takes; else the handle's device).

    The coarse stage is :func:`~raft_tpu_torch.ann.build_ivf_flat` (f32
    slab). Then per subspace of width ``d / pq_dim`` a ``2^pq_bits``
    codebook is trained with ``kmeans_fit(balanced=False)`` on a residual
    sample (``pq_train_rows``, default ``max(32·K, 4096)``), every slab row
    is encoded to its nearest codeword, and the error envelopes are
    recorded (:func:`_pq_encode`). ``pq_mode`` ∈ :data:`PQ_MODES` (default
    ``RAFT_TPU_ANN_PQ_MODE``); ``pq_bits`` ∈ (4, 8) (default
    ``RAFT_TPU_ANN_PQ_BITS``); ``pq_dim`` defaults to the largest divisor
    of d not above d/4. The index's ``build_seconds`` holds the host-clock
    seconds of the coarse, codebook and encode stages."""
    res = ensure_resources(res)
    dev = y.device if isinstance(y, torch.Tensor) else res.device
    y = as_f32(y, dev)
    m, d = y.shape
    require_finite_rows(y, "build_ivf_pq")
    if pq_mode is None:
        pq_mode = env.get("RAFT_TPU_ANN_PQ_MODE")
    expects(pq_mode in PQ_MODES,
            "build_ivf_pq: pq_mode must be one of %s, got %r", PQ_MODES,
            pq_mode)
    if pq_bits is None:
        pq_bits = env.get("RAFT_TPU_ANN_PQ_BITS")
    pq_bits = int(pq_bits)
    expects(pq_bits in (4, 8),
            "build_ivf_pq: pq_bits must be 4 or 8, got %d", pq_bits)
    S = int(pq_dim) if pq_dim else _default_pq_dim(d)
    expects(S >= 1 and d % S == 0,
            "build_ivf_pq: pq_dim=%d must divide d=%d", S, d)
    expects(pq_bits == 8 or S % 2 == 0,
            "build_ivf_pq: 4-bit codes pack two per byte — pq_dim=%d must "
            "be even", S)
    K = 1 << pq_bits
    expects(m >= K, "build_ivf_pq: %d rows < 2^pq_bits = %d codewords — "
            "shrink pq_bits or use IVF-Flat", m, K)
    t0 = time.perf_counter()
    flat = build_ivf_flat(res, y, n_lists=n_lists, n_probes=n_probes,
                          max_iter=max_iter, seed=seed, balanced=balanced,
                          row_quantum=row_quantum,
                          max_train_rows=max_train_rows)
    _sync(dev)
    t1 = time.perf_counter()
    rot, books = _train_codebooks(res, flat, S, K, pq_max_iter, seed,
                                  pq_train_rows, pq_mode, opq_iters)
    _sync(dev)
    t2 = time.perf_counter()
    idx = IvfPqIndex(flat, pq_dim=S, pq_bits=pq_bits, codebooks=books,
                     pq_mode=pq_mode, pq_rot=rot,
                     **_pq_encode(res, flat, books, rot, pq_bits, pq_mode))
    _sync(dev)
    idx.build_seconds = {"coarse": t1 - t0, "codebooks": t2 - t1,
                         "encode": time.perf_counter() - t2}
    return idx


# ----------------------------------------------------------------- search
def _pq_certify(bound, theta, widen):
    """certified ⇔ no probed row outside the pool can beat the exact k-th
    value: ``bound`` is the pooled rest-min of the per-row certified lower
    bounds, so ``widen`` carries only the kernel-precision envelope.
    Module-level so tests can force the widen and rerun rungs."""
    return bound >= theta + widen


def _pq_lut(x, codebooks, S: int, dsub: int):
    """The per-query ADC table ``lut[q, s·K + j] = x_{q,s} · cb_s[j]``
    (f32, TF32 off), flattened subspace-major."""
    lut = torch.einsum("qsd,skd->qsk", x.reshape(x.shape[0], S, dsub),
                       codebooks)
    return lut.reshape(x.shape[0], -1).contiguous()


def adc_operands(index: IvfPqIndex, xs, probes_np, pr):
    """K5's operands for the queries ``xs`` [nq, d] with probe lists
    ``probes_np`` (host) / ``pr`` (device): ``(sched, xx, probes, cdot,
    lut, codes, yy_pq, eq_rows, Wk)`` as :func:`~raft_tpu_torch.ops.
    pq_scan.pq_scan_list_major` takes them (queries padded to 8), and the
    host schedule (its probed-list count and streamed rows)."""
    sch = build_list_schedule(index, probes_np)
    sched = torch.from_numpy(sch.sched).to(xs.device)
    xp, pp, _ = _pad_kernel_operands(xs, pr)
    xx = (xp * xp).sum(1, keepdim=True)
    # the rotation applies to the query side of the table only: codes
    # encode r·R and x·(r̂'Rᵀ) = (x·R)·r̂'; the centroid term and the exact
    # rescore stay in the original basis
    xq = xp if index.pq_rot is None else xp @ index.pq_rot
    lut = _pq_lut(xq, index.codebooks, index.pq_dim, index.dsub)
    cdot = (xp @ index.centroids[sched[3].long().clamp_min(0)].T) \
        .contiguous()
    return (sched, xx, pp, cdot, lut, index.codes, index.yy_pq,
            index.pq_eq_rows, pad_window(index.probe_window)), sch


def pq_scan_chunk(index: IvfPqIndex, xs, probes_np, pr, st, ps, k: int,
                  P: int, W: int, ids=None, pool_depth: int = 2):
    """One ADC call over the queries ``xs`` → (vals, ids, certified,
    margin) (reference ``:558``). ``probes_np`` / ``pr`` are the probe
    lists on the host and on the device, ``st`` / ``ps`` their slab
    offsets and padded sizes; ``ids`` overrides the slab id map (the
    mutable plane passes its tombstone-masked ``ids_live``: a masked row
    rescores to +inf, and the certificate compares against the same
    masked oracle); ``pool_depth`` ∈ (2, 4, 8) sizes the per-slot pool.
    ``margin`` is bound − θ − e_k.

    The certificate is per query: the kernel pools each row's certified
    lower bound, so the pooled rest-min is compared with θ plus only the
    kernel-precision envelope e_k. e_k is the reference's: its first term
    covers the bf16 hi/lo table's ≤ ~2⁻¹⁷ relative error per entry against
    ‖x‖·‖r̂‖ (Cauchy–Schwarz over the subspaces). The port's kernel sums
    the exact f32 table entries instead, whose error is at most
    S·2⁻²⁴·‖x‖·‖r̂‖ (the table products) plus the f32 sum's, so the first
    term's factor is max(2⁻¹⁵, S·2⁻²⁴): the reference's 2⁻¹⁵ verbatim for
    S ≤ 512 (always at 8 bits, where the shared-memory cap keeps S ≤ 227),
    S·2⁻²⁴ past it (4-bit tables admit S up to 3632). The second term
    covers the f32 adds over the score magnitude in both."""
    nq, d = xs.shape
    args, _ = adc_operands(index, xs, probes_np, pr)
    pool = pq_scan_list_major(*args, pq_bits=index.pq_bits,
                              pool_depth=pool_depth)
    xx = args[1][:nq]
    rows = torch.cat([pool[2 * t + 1][:nq] for t in range(pool_depth)], 1)
    vals, out_ids = _pool_finish(xs, xx, rows, index.slab,
                                 index.ids if ids is None else ids,
                                 index.yy_slab, st, ps, k, P, W)
    theta = vals[:, k - 1]
    bound = pool[2 * pool_depth][:nq].min(1).values
    pl = pr.long()
    eq_w = index.pq_eq_list[pl].max(1).values
    yymax = _list_host(index)["yy_lmax"][pl].max(1).values
    rhat_w = index.pq_rhat_list[pl].max(1).values
    xnorm = xx[:, 0].sqrt()
    span = (xnorm + yymax.sqrt() + eq_w) ** 2
    e_k = max(2.0 ** -15, index.pq_dim * 2.0 ** -24) * xnorm * rhat_w \
        + (2.0 ** -20 + d * 2.0 ** -24) * span
    return vals, out_ids, _pq_certify(bound, theta, e_k), bound - (theta
                                                                   + e_k)


def _adc_chunk(nq: int, P: int, d: int, depth: int, S: int, K: int,
               L: int) -> int:
    """Queries per ADC call: the table, the centroid dots, the pools and
    the rescore's [C, d] rows and [C, P] slot table of each query under
    :data:`_PQ_BUDGET`, C = 128·depth pooled rows."""
    C = 128 * depth
    per_q = 4 * (S * K + L + C * (2 + d)) + 9 * C * P
    return max(8, min(nq, _PQ_BUDGET // per_q))


def _adc(index: IvfPqIndex, x, probes, probes_host, starts, psizes, k: int,
         P: int, W: int, depth: int):
    """:func:`pq_scan_chunk` over a batch in budget-sized query chunks.
    Returns (vals, ids, certified, margin)."""
    qc = _adc_chunk(x.shape[0], P, x.shape[1], depth, index.pq_dim,
                    index.pq_k, index.n_lists)
    outs = [pq_scan_chunk(index, x[s:s + qc], probes_host[s:s + qc],
                          probes[s:s + qc], starts[s:s + qc],
                          psizes[s:s + qc], k, P, W, pool_depth=depth)
            for s in range(0, x.shape[0], qc)]
    return tuple(torch.cat([o[n] for o in outs]) for n in range(4))


def expected_pq_rerun_frac(index: IvfPqIndex, probes_np=None
                           ) -> Tuple[float, str]:
    """Measured-or-modeled expected certificate-rerun fraction (reference
    ``:640``): the fraction measured at this call site in this process
    once 64 queries have walked the ladder, else the model
    ``min(1, (q90 Eq / median ‖y − c‖)²)`` from the build's per-list
    sketch (restricted to the probed lists when given). Returns
    ``(frac, source)``, source ∈ (measured, modeled, unmodeled)."""
    from raft_tpu_torch.observability.quality import measured_rerun_frac

    m = measured_rerun_frac(_SITE)
    if m is not None:
        return float(m), "measured"
    q = getattr(index, "pq_eq_qlist", None)
    med = float(getattr(index, "pq_resid_med", 0.0) or 0.0)
    if q is None or med <= 0.0:
        return 0.0, "unmodeled"
    q = np.asarray(q)
    if probes_np is not None and q.ndim == 2 and q.shape[0]:
        lists = np.unique(np.asarray(probes_np).ravel())
        lists = lists[(lists >= 0) & (lists < q.shape[0])]
        if lists.size:
            q = q[lists]
    live = q[q[:, 2] > 0.0] if q.size else q
    if not live.size:
        return 0.0, "unmodeled"
    ratio = float(np.median(live[:, 1])) / med
    return float(min(1.0, ratio * ratio)), "modeled"


def resolve_pq_scan(index: IvfPqIndex, nq: int, k: int, P: int, W: int,
                    requested: Optional[str] = None,
                    probes_np=None) -> str:
    """The schedule of one :func:`search_ivf_pq` call (reference
    ``:679``); ``None`` reads ``RAFT_TPU_IVF_PQ_SCAN`` (default auto).

    Envelope (outside it every request runs flat, with a logged warning
    for an explicit ``"pq"``): the slab covers one kernel window, ``k``
    leaves room in the 256-slot pool, at most 128 probes, and the query's
    table fits a block's shared memory (227 KB). The reference's scoped-
    VMEM and lane-alignment tests are TPU terms, and its tune table is not
    read. ``"auto"`` is the cost-model crossover at the rerun-aware
    expected bytes (:func:`expected_pq_rerun_frac`)."""
    from raft_tpu_torch.observability.costmodel import (choose_pq_scan,
                                                        ivf_traffic_model)

    req = requested if requested is not None \
        else env.get("RAFT_TPU_IVF_PQ_SCAN")
    if req not in PQ_SCANS:
        raise ValueError(f"pq_scan must be one of {PQ_SCANS}, got {req!r}")
    if req == "flat":
        return "flat"
    Wk = pad_window(W)
    smem = pq_scan_smem_bytes(index.pq_dim, index.pq_bits)
    reason = None
    if index.slab_rows < Wk:
        reason = f"slab rows {index.slab_rows} < kernel window {Wk}"
    elif k > _LIST_K_MAX:
        reason = f"k={k} > {_LIST_K_MAX} exceeds the candidate pool"
    elif P > 128:
        reason = f"n_probes={P} > 128 exceeds the probe table"
    elif smem > MAX_SMEM_BYTES:
        reason = (f"the {index.pq_dim}x{index.pq_k} ADC table needs {smem} "
                  f"bytes of shared memory, over {MAX_SMEM_BYTES}")
    if reason is not None:
        if req == "pq":
            _log.warning("pq_scan='pq' outside the ADC envelope (%s): using "
                         "the flat scan for this call", reason)
        return "flat"
    if req == "pq":
        return "pq"
    frac, src = expected_pq_rerun_frac(index, probes_np)
    model = ivf_traffic_model(
        nq, index.n_rows, index.d_orig, k, index.n_lists, P, W,
        index.slab_rows, list_sizes=index._np_sizes,
        padded_sizes=index._np_padded, pq_dim=index.pq_dim,
        pq_bits=index.pq_bits, pq_rerun_frac=frac)
    pick = choose_pq_scan(model)
    if pick == "flat" and choose_pq_scan(model, rerun_frac=0.0) == "pq":
        _log.warning("pq_scan auto: expected certificate-rerun fraction "
                     "%.2f (%s) prices the ADC scan above the flat scan: "
                     "flat for this call", frac, src)
    return pick


@instrument("ann.search_ivf_pq")
def search_ivf_pq(res, index: IvfPqIndex, queries, k: int,
                  n_probes: Optional[int] = None,
                  pq_scan: Optional[str] = None, with_stats: bool = False):
    """Approximate top-k against an :class:`IvfPqIndex` (reference
    ``:774``).

    Returns (d2 [nq, k] ascending, global ids [nq, k] int32), like
    ``search_ivf_flat``: the values are exact f32 distances (every
    candidate is rescored from the f32 slab) and the id sets equal the
    flat scan's over the same probes (the certificate ladder, see the
    module doc). ``pq_scan`` ∈ :data:`PQ_SCANS` (``None`` reads
    ``RAFT_TPU_IVF_PQ_SCAN``); ``n_probes`` defaults to the index's;
    ``n_probes ≥ n_lists`` (or ``k`` past the probed capacity) runs the
    exact plane. ``with_stats`` appends the number of queries that paid
    the exact rerun (or the exact plane's fixup). Runs on the index's
    device."""
    fault_point("ivf_search")
    expects(isinstance(index, IvfPqIndex),
            "search_ivf_pq: index must be an IvfPqIndex (got %s)",
            type(index).__name__)
    if res is None and index.device.type == "cpu":
        res = DeviceResources(device="cpu")
    res = ensure_resources(res)
    x = as_f32(queries, index.device)
    expects(x.ndim == 2 and x.shape[1] == index.d_orig,
            "search_ivf_pq: query width %s != index %d",
            tuple(x.shape[1:]), index.d_orig)
    expects(k >= 1, "search_ivf_pq: k must be >= 1")
    expects(k <= index.n_rows, "search_ivf_pq: k=%d > index size %d", k,
            index.n_rows)
    nq = x.shape[0]
    if nq == 0:
        out = (x.new_zeros((0, k)),
               torch.zeros((0, k), dtype=torch.int32, device=x.device), 0)
        return out if with_stats else out[:2]
    L = index.n_lists
    P = index.n_probes_default if n_probes is None else int(n_probes)
    expects(P >= 1, "search_ivf_pq: n_probes must be >= 1, got %d", P)
    W = index.probe_window
    if P >= L or k > P * W:
        _log.info("search_ivf_pq: n_probes=%d of %d lists, k=%d: exact "
                  "search over the f32 slab", P, L, k)
        if explain.active() is not None:
            explain.note(plane="ivf_pq", exact_degrade=exact_reason(
                P, L, k, W), n_probes=P, n_lists=L, k=k)
        out = _exact_search(index, x, k)
        return out if with_stats else out[:2]
    probes = _coarse_probe(res, index.centroids, x, P)           # [nq, P]
    probes_host = probes.cpu().numpy()
    pl = probes.long()
    starts, psizes = index.offsets[:-1][pl], index.padded_sizes[pl]
    chunk = max(8, _FINE_TILE // max(1, P * W * x.shape[1]))
    schedule = resolve_pq_scan(index, nq, k, P, W, pq_scan,
                               probes_np=probes_host)
    if explain.active() is not None:
        explain.note(plane="ivf_pq", n_probes=P, n_lists=L, k=k,
                     pq_bits=index.pq_bits, pq_dim=index.pq_dim,
                     pq_scan=schedule,
                     **probe_notes(index._np_sizes, probes_host),
                     pool_width=256)
    if schedule == "pq":
        # the reference degrades a failure here to the flat scan; the
        # port raises it (no fallback hides K5)
        fault_point("pq_scan")
        out = _search_pq(index, x, probes, probes_host, starts, psizes, k, P,
                         W, chunk)
    else:
        out = _query_major(index, x, starts, psizes, k, P, W, chunk)
    return out if with_stats else out[:2]


def _search_pq(index: IvfPqIndex, x, probes, probes_host, starts, psizes,
               k: int, P: int, W: int, chunk: int):
    """The certificate ladder (reference ``:889``): the ADC scan at the
    256-slot pool; the queries that fail it re-run at 512, then 1024 slots
    (up to ``RAFT_TPU_ANN_PQ_WIDEN``); those still failing rerun through
    the exact query-major f32 scan in chunks of ``chunk``. Pools and
    certificates are per query, so re-running only the failing queries
    gives the reference's ids. Returns (vals, ids, exact reruns)."""
    nq = x.shape[0]
    vals, ids, ok, margin = _adc(index, x, probes, probes_host, starts,
                                 psizes, k, P, W, 2)
    explain.note_margin(_SITE, margin)
    n_fail0 = n_fail = int((~ok).sum())
    widen_cap = int(env.get("RAFT_TPU_ANN_PQ_WIDEN"))
    depth_used = 2
    for factor in (2, 4):
        if factor > widen_cap or not n_fail:
            break
        bad = (~ok).nonzero().squeeze(1)
        # the reference degrades a failure here to the exact rerun; the
        # port raises it
        fault_point("pq_widen")
        wv, wi, wok, _ = _adc(index, x[bad], probes[bad],
                              probes_host[bad.cpu().numpy()], starts[bad],
                              psizes[bad], k, P, W, 2 * factor)
        vals[bad], ids[bad], ok[bad] = wv, wi, wok
        n_fail = int((~ok).sum())
        depth_used = 2 * factor
    record_certificate(_SITE, n_queries=nq, n_fail=n_fail,
                       pool_width=128 * depth_used,
                       fixup_rows=n_fail or None, rerun=bool(n_fail),
                       pq_bits=index.pq_bits, n_probes=P)
    record_pq_rungs(_SITE, certified=nq - n_fail0,
                    widened=n_fail0 - n_fail, exact_rerun=n_fail)
    if explain.active() is not None:
        explain.note(pq_rungs={"certified": nq - n_fail0,
                               "widened": n_fail0 - n_fail,
                               "exact_rerun": n_fail})
    if n_fail:
        explain.note(rerun="pq_exact", rerun_rows=n_fail)
        # the true top-k (or a tie) may hide outside the pool: these
        # queries rerun through the exact f32 scan
        bad = (~ok).nonzero().squeeze(1)
        vals[bad], ids[bad], _ = _query_major(index, x[bad], starts[bad],
                                              psizes[bad], k, P, W, chunk)
    return vals, ids, n_fail


def warm_pq_scan(res, index: IvfPqIndex, nq: int, k: int,
                 n_probes: int) -> int:
    """Load and launch everything a serving bucket of ``nq`` queries can
    reach on the PQ plane (reference ``:999``): one flat search, then K5
    once per pool depth the widen cap allows, on an empty schedule. In
    eager PyTorch nothing compiles per shape, so this keeps the engine's
    "no kernel build or load after warm-up" gate. Returns the K5 launches
    (0 outside the ADC envelope)."""
    P = min(max(1, int(n_probes)), index.n_lists)
    if P >= index.n_lists or nq < 1:
        return 0            # the exact plane
    W = index.probe_window
    dev = index.device
    search_ivf_pq(res, index, torch.zeros((nq, index.d_orig), device=dev),
                  k, n_probes=P, pq_scan="flat")
    if resolve_pq_scan(index, nq, k, P, W, "pq") != "pq":
        return 0
    nqp = -(-nq // 8) * 8
    sched = torch.zeros((4, LISTS_PER_CELL), dtype=torch.int32, device=dev)
    sched[3] = -1
    widen_cap = int(env.get("RAFT_TPU_ANN_PQ_WIDEN"))
    depths = [2] + [2 * f for f in (2, 4) if f <= widen_cap]
    for depth in depths:
        pq_scan_list_major(
            sched, torch.zeros(nqp, device=dev),
            torch.full((nqp, 1), -2, dtype=torch.int32, device=dev),
            torch.zeros((nqp, LISTS_PER_CELL), device=dev),
            torch.zeros((nqp, index.pq_dim * index.pq_k), device=dev),
            index.codes, index.yy_pq, index.pq_eq_rows, pad_window(W),
            index.pq_bits, depth)
    return len(depths)
