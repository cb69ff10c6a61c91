"""List-major IVF fine scan (K4): wrappers, plain twins and constants.

Counterpart of ``raft_tpu/ops/fine_scan_pallas.py``. The TPU kernels
``fine_scan_list_major`` (``:280``) and ``fine_scan_list_major_q8``
(``:329``) become the hand-written Hopper kernel in ``csrc/fine_scan.cu``
(one source templated on the slab type); see that file for the design.

The contract (the reference's): for every schedule entry ``j`` with
``(start, lsize, off, lid) = sched[:, j]``, every query is scored against
the window rows ``start .. start+Wk``; queries whose probe table holds no
``lid`` and window columns outside ``[off, off+lsize)`` are masked to
+inf; each remaining score folds into the query's 128 slots, a row's slot
being ``(row − start) % 128``, as the top-2 (value, global slab row) and a
running 3rd-min. Slots where nothing was scored read (+inf, −1). Scores
approximate ``xx + ‖y‖² − 2·x·y`` (f32), or ``xx + s²·‖yq‖² − 2·s·x·yq``
for an int8 slab with per-list scale ``s``, from the reference's bf16 hi/lo
terms; the kernel and the twin (:func:`_scan_ref`) sum the same terms in
other orders, each within :func:`sum_bound` of their exact sum.

The wrappers dispatch on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.fused_l2_topk import split_hi_lo

_LANES = 128
#: lists per schedule cell: build_list_schedule pads its list table to a
#: multiple of this (the reference's 8-row quantum, kept so one schedule
#: drives both packages)
LISTS_PER_CELL = 8
#: widest feature dimension the kernel takes: the member queries' rows sit
#: in shared memory, and ‖yq‖² of an int8 row stays an exact f32 integer
MAX_D = 1024
#: bytes of the per-(query, probe) partial pools one call may hold
#: (5 arrays × nq × P × 128 × 4 bytes)
PARTIAL_BUDGET = 1 << 30

# kernel launches since import (or since a caller reset them), one per
# wrapper call that launched: the scan and the merge that completes it
LAUNCHES = 0
LAUNCHES_Q8 = 0

_FN = None


def sum_bound(d: int) -> float:
    """The f32 summation error of one score, kernel or twin, over the
    exact sum of the same bf16 terms, as a factor of (‖x‖ + ‖y‖)²:
    (5d + 8)·2⁻²⁴ (derived in csrc/fine_scan.cu). The two agree within
    twice it."""
    return (5 * d + 8) * 2.0 ** -24


def pad_window(W: int) -> int:
    """The kernel window for a probe window ``W``: rounded up to whole
    128-row chunks."""
    return -(-max(W, 1) // _LANES) * _LANES


def max_list_chunk(n_probes: int) -> int:
    """Most queries one list-major call takes at ``n_probes`` probes,
    from :data:`PARTIAL_BUDGET`."""
    return max(8, PARTIAL_BUDGET // (max(1, n_probes) * _LANES * 20))


def _check(sched, x, xx, probes, slab, Wk: int, scale_l=None):
    if Wk <= 0 or Wk % _LANES:
        raise ValueError(f"fine scan: Wk={Wk} must be a positive multiple "
                         f"of {_LANES}")
    if sched.ndim != 2 or sched.shape[0] != 4 or \
            sched.shape[1] % LISTS_PER_CELL:
        raise ValueError(f"fine scan: sched must be [4, Lp] with Lp a "
                         f"multiple of {LISTS_PER_CELL}, got "
                         f"{tuple(sched.shape)}")
    nqp, d = x.shape
    if xx.numel() != nqp or probes.ndim != 2 or probes.shape[0] != nqp \
            or not 0 < probes.shape[1] <= _LANES:
        raise ValueError(f"fine scan: xx {tuple(xx.shape)} and probes "
                         f"{tuple(probes.shape)} must cover the {nqp} "
                         f"queries, with 1..{_LANES} probe columns")
    if slab.ndim != 2 or slab.shape[1] != d:
        raise ValueError(f"fine scan: slab {tuple(slab.shape)} does not "
                         f"match d={d}")
    if scale_l is not None and scale_l.shape != (sched.shape[1],):
        raise ValueError(f"fine scan: scale_l {tuple(scale_l.shape)} must "
                         f"hold one scale per schedule entry")


def fine_scan_list_major(sched, x, xx, probes, slab, Wk: int):
    """List-major fine scan over the f32 slab.

    sched [4, Lp] int32 (window start, list length, list offset in the
    window, list id; pad entries ``(0, 0, 0, -1)``); x [nqp, d] f32; xx
    [nqp] or [nqp, 1] f32 query squared norms; probes [nqp, P ≤ 128] int32
    (pads −2); slab [R, d] f32. Returns (a1, i1, a2, i2, a3), each
    [nqp, 128] (f32 / int32 / f32 / int32 / f32)."""
    global LAUNCHES
    _check(sched, x, xx, probes, slab, Wk)
    if x.device.type == "cpu":
        return fine_scan_list_major_ref(sched, x, xx, probes, slab, Wk)
    out = _launch(sched, None, x, xx, probes, slab, Wk, torch.float32)
    LAUNCHES += 1
    return out


def fine_scan_list_major_q8(sched, scale_l, x, xx, probes, slab_q,
                            Wk: int):
    """List-major fine scan over the int8 slab ``slab_q`` [R, d] with the
    per-entry list scale ``scale_l`` [Lp] f32, applied to the accumulated
    sums, never to a widened copy of the slab. Same schedule and pool
    contract as :func:`fine_scan_list_major`."""
    global LAUNCHES_Q8
    _check(sched, x, xx, probes, slab_q, Wk, scale_l)
    if x.device.type == "cpu":
        return fine_scan_list_major_q8_ref(sched, scale_l, x, xx, probes,
                                           slab_q, Wk)
    out = _launch(sched, scale_l, x, xx, probes, slab_q, Wk, torch.int8)
    LAUNCHES_Q8 += 1
    return out


def _members(sched, probes):
    """The probe table inverted, on the device: ``js`` [nqp, P] int32, each
    query's schedule entries in ascending order (−1 where a probe names no
    entry, or repeats one), and the member table ``order`` [nqp·P] int32 of
    (query·P + column) sorted by entry, entry ``j`` owning
    ``order[seg[j]:seg[j+1]]``."""
    nqp, Pp = probes.shape
    Lp = sched.shape[1]
    ls, lperm = torch.sort(sched[3].contiguous())
    pos = torch.searchsorted(ls, probes.contiguous()).clamp_max(Lp - 1)
    hit = (ls[pos] == probes) & (probes >= 0)
    js = torch.sort(torch.where(hit, lperm[pos], Lp), dim=1).values
    dup = torch.zeros_like(hit)
    dup[:, 1:] = js[:, 1:] == js[:, :-1]
    js = torch.where(dup, Lp, js)
    key = js.reshape(-1)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    # counts by scatter, not torch.bincount: on the card that reads the
    # key's max back to the host, a sync on every launch of K4 and K5
    counts = torch.zeros(Lp + 1, dtype=torch.int64, device=probes.device)
    counts.scatter_add_(0, key.long(), torch.ones_like(key, dtype=torch.int64))
    seg = torch.zeros(Lp + 1, dtype=torch.int32, device=probes.device)
    seg[1:] = torch.cumsum(counts[:Lp], 0)
    return torch.where(js == Lp, -1, js).to(torch.int32), order, seg


#: member queries a work item of the kernel takes (csrc/fine_scan.cu kBQ)
ITEM_MEMBERS = 32


def live_chunks(sched, Wk: int, R: int):
    """Each schedule entry's live 128-row chunks of its window: those
    holding the list's rows inside the window and the slab (the kernel's
    c_lo .. c_hi, csrc/fine_scan.cu). Returns (first chunk, count), [Lp]
    int64 each."""
    start, lsize, off = (sched[i].long() for i in range(3))
    c_lo = torch.maximum(off.clamp_min(0), -start)
    c_hi = torch.minimum((off + lsize).clamp_max(Wk), R - start)
    ch_lo = torch.div(c_lo, _LANES, rounding_mode="floor")
    n_ch = torch.where(c_hi > c_lo,
                       torch.div(c_hi + _LANES - 1, _LANES,
                                 rounding_mode="floor") - ch_lo, 0)
    return ch_lo, n_ch


def plan_items(sched, seg, n_members: int, Wk: int, R: int):
    """The kernel's work items, on the device and without a host read:
    ``[n, 2]`` int32 rows (entry, first position in the member table), one
    for every batch of :data:`ITEM_MEMBERS` consecutive members of an entry
    (an entry with no member has none), the entries longest first (most
    live chunks; ties by entry), then rows (−1, −1). ``n`` = min(M, Lp +
    ⌈M / ITEM_MEMBERS⌉) for a member table of M positions bounds the count,
    so the launch's grid needs no host read. Each item takes every live
    chunk of its entry: every (entry, member, live chunk) is covered
    once."""
    Lp = sched.shape[1]
    dev = seg.device
    _, n_ch = live_chunks(sched, Wk, R)
    seg = seg.long()
    batches = torch.div(seg[1:] - seg[:-1] + ITEM_MEMBERS - 1, ITEM_MEMBERS,
                        rounding_mode="floor")
    order = torch.sort(-n_ch, stable=True).indices          # [Lp]
    ends = torch.cumsum(batches[order], 0)
    n = min(n_members, Lp + -(-n_members // ITEM_MEMBERS))
    t = torch.arange(n, device=dev)
    k = torch.searchsorted(ends, t, right=True).clamp_max(Lp - 1)
    entry = order[k]
    p0 = seg[entry] + (t - (ends[k] - batches[entry])) * ITEM_MEMBERS
    ok = t < ends[Lp - 1]
    items = torch.stack([torch.where(ok, entry, -1),
                         torch.where(ok, p0, -1)], dim=1)
    return items.to(torch.int32).contiguous()


def _launch(sched, scale_l, x, xx, probes, slab, Wk: int, slab_dtype):
    if x.device.type != "cuda":
        raise DeviceError(f"fine scan: no kernel for device {x.device}")
    nqp, d = x.shape
    if d > MAX_D:
        raise ValueError(f"fine scan: the Hopper kernel takes d ≤ {MAX_D}, "
                         f"got d={d}")
    xx = xx.reshape(nqp)
    args = [("sched", sched, torch.int32), ("x", x, torch.float32),
            ("xx", xx, torch.float32), ("probes", probes, torch.int32),
            ("slab", slab, slab_dtype)]
    if scale_l is not None:
        args.append(("scale_l", scale_l, torch.float32))
    for name, t, dt in args:
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fine scan: {name} must be a contiguous {dt} "
                             f"tensor on {x.device}")
    Pp, R, Lp = probes.shape[1], slab.shape[0], sched.shape[1]
    js, order, seg = _members(sched, probes)
    items = plan_items(sched, seg, order.numel(), Wk, R)
    dev = x.device

    def pools(rows):
        return [torch.empty((rows, _LANES), dtype=dt, device=dev)
                for dt in (torch.float32, torch.int32, torch.float32,
                           torch.int32, torch.float32)]

    parts, outs = pools(nqp * Pp), pools(nqp)
    with torch.cuda.device(dev):
        rc = _launcher()(
            sched.data_ptr(),
            scale_l.data_ptr() if scale_l is not None else None,
            x.data_ptr(), xx.data_ptr(), slab.data_ptr(), seg.data_ptr(),
            order.data_ptr(), js.data_ptr(), items.data_ptr(),
            *(t.data_ptr() for t in parts), *(t.data_ptr() for t in outs),
            items.shape[0], nqp, Pp, d, R, Lp, Wk, int(scale_l is not None),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"fine scan: launch failed with CUDA error {rc}")
    return tuple(outs)


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("fine_scan").fine_scan_list_major_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 19 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


# ------------------------------------------------------------ plain twins
def _fold_pool(acc, d2, base_row: int, Wk: int):
    """Fold a masked [nqp, Wk] window into the 128-slot pools, 128
    columns at a time (reference ``_fold_pool``, ``:138``)."""
    a1, i1, a2, i2, a3 = acc
    lane = torch.arange(_LANES, dtype=torch.int32, device=d2.device)
    for r in range(Wk // _LANES):
        c = d2[:, r * _LANES:(r + 1) * _LANES]
        ci = (base_row + r * _LANES + lane)[None, :]
        lt1, lt2, lt3 = c < a1, c < a2, c < a3
        a3 = torch.where(lt2, a2, torch.where(lt3, c, a3))
        a2 = torch.where(lt1, a1, torch.where(lt2, c, a2))
        i2 = torch.where(lt1, i1, torch.where(lt2, ci, i2))
        a1 = torch.where(lt1, c, a1)
        i1 = torch.where(lt1, ci, i1)
    return a1, i1, a2, i2, a3


def _window(slab, start: int, Wk: int):
    """Rows ``start .. start+Wk`` of the slab as f32, zero outside it
    (those columns are masked: the kernel reads only inside the slab)."""
    R = slab.shape[0]
    lo, hi = max(start, 0), max(min(start + Wk, R), max(start, 0))
    y = slab[lo:hi].float()
    before, after = lo - start, Wk - (hi - start)
    if before or after:
        y = torch.cat([y.new_zeros((before, slab.shape[1])), y,
                       y.new_zeros((after, slab.shape[1]))])
    return y


def _scan_ref(sched, scale_l, x, xx, probes, slab, Wk: int):
    """The schedule walked entry by entry as the reference's kernel body
    does (``_list_kernel_body``, ``:159``), each window scored with the
    reference's terms (``_scores_f32``, ``_scores_q8`` with x hi and x lo):
    products of bf16 values, exact in f32, summed by ``torch.matmul`` (TF32
    off), and the norm as Σ hi(y²) + Σ lo(y²). The kernel computes the same
    terms; the two differ by the order of the f32 sums alone (see
    csrc/fine_scan.cu)."""
    nqp = x.shape[0]
    dev = x.device
    R = slab.shape[0]
    xx = xx.reshape(nqp, 1)
    xh, xl = (t.float() for t in split_hi_lo(x))
    inf = torch.full((nqp, _LANES), float("inf"), device=dev)
    neg1 = torch.full((nqp, _LANES), -1, dtype=torch.int32, device=dev)
    acc = (inf, neg1, inf.clone(), neg1.clone(), inf.clone())
    colv = torch.arange(Wk, device=dev)
    for j, (st, lsize, off, lid) in enumerate(sched.T.tolist()):
        y = _window(slab, st, Wk)
        if scale_l is None:
            yh, yl = (t.float() for t in split_hi_lo(y))
            s = xh @ yh.T + xh @ yl.T + xl @ yh.T
            y2h, y2l = (t.float() for t in split_hi_lo(y * y))
            r = (y2h.sum(1) + y2l.sum(1)) - 2.0 * s
        else:
            # codes are exact in bf16 and their squares' sum in f32
            s = xh @ y.T + xl @ y.T
            sc = scale_l[j]
            r = (sc * sc) * (y * y).sum(1) - (2.0 * sc) * s
        d2 = xx + r
        member = (probes == lid).any(1)
        row = st + colv
        valid = (colv >= off) & (colv < off + lsize) & (row >= 0) & (row < R)
        d2 = torch.where(member[:, None] & valid[None, :], d2, float("inf"))
        acc = _fold_pool(acc, d2, st, Wk)
    return acc


def fine_scan_list_major_ref(sched, x, xx, probes, slab, Wk: int):
    """Plain PyTorch twin of :func:`fine_scan_list_major` (see
    :func:`_scan_ref`). The CPU path and the kernel's on-card oracle."""
    _check(sched, x, xx, probes, slab, Wk)
    return _scan_ref(sched, None, x, xx, probes, slab, Wk)


def fine_scan_list_major_q8_ref(sched, scale_l, x, xx, probes, slab_q,
                                Wk: int):
    """Plain twin of :func:`fine_scan_list_major_q8`: x hi and x lo
    against the codes (exact in bf16), summed in f32, the list scale
    applied after the sums (``_scores_q8``, ``:116``)."""
    _check(sched, x, xx, probes, slab_q, Wk, scale_l)
    return _scan_ref(sched, scale_l, x, xx, probes, slab_q, Wk)
