"""Fused L2 distance + group top-2 fold (K1, and K2 over an int8
database) — the port's hot step.

Counterpart of ``raft_tpu/ops/fused_l2_topk_pallas.py``. The TPU kernel
``fused_l2_group_topk_packed`` (``:1269``; its database-major forms
``_packed_db``/``_packed_dbuf`` compute the same outputs), its int8
twins ``fused_l2_group_topk_packed_db_q8`` / ``_dbuf_q8`` (``:1465``,
``:1491``) and its wide-feature form
``fused_l2_group_topk_packed_dchunk`` (``:1294``) become the hand-written
Hopper kernels in ``csrc/fused_l2_packed_sm90.cu`` (wgmma fed by TMA
through an mbarrier ring, the wide form in clusters that share y; see
that file for the design). The unpacked forms
``fused_l2_group_topk`` (``:1230``) and ``fused_l2_group_topk_dchunk``
(``:1254``), and K1's first, per-slot forms ``fused_l2_slot_topk``
(``:406``) and ``fused_l2_slot_topk_dchunk`` (``:474``), which no search
path calls (the reference's stage ladder,
``benchmarks/profile_fused.py:146-165``, times them beside the group
forms), are one ``mma.sync`` kernel templated on the form in
``csrc/fused_l2_topk.cu``. This module holds the wrappers, their plain
PyTorch twins and the packing constants the certified KNN decodes with.

The wrapper dispatches on the device of the tensors it is given: CPU
tensors take the twin, CUDA tensors launch the kernel (or raise). There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build

_LANES = 128
_PACK_BITS = 8                   # default code width (see the reference)
_PBITS_MAX = 13                  # widest codes: value error 2^(13-23)
_PACK_PAD = float(2.0 ** 125)    # finite "never wins" sentinel

# kernel launches since import (or since a caller reset it): a run that
# reads it before and after shows the path went through the kernel
LAUNCHES = 0
# K2's launches, counted the same way
LAUNCHES_Q8 = 0
# the d-chunked packed form's, the unpacked form's and its d-chunked
# form's launches
LAUNCHES_DCHUNK = 0
LAUNCHES_GROUP = 0
LAUNCHES_GROUP_DCHUNK = 0
# the slot forms' launches (the resident form and its d-chunked form)
LAUNCHES_SLOT = 0
LAUNCHES_SLOT_DCHUNK = 0

_FN = None
_FN_Q8 = None
_FN_DCHUNK = None
_FN_GROUP = None
_FN_SLOT = {}
# widest d the resident slot form holds in shared memory (K1's resident
# envelope; past it the d-chunked form streams x)
_D_RESIDENT = 512


def _check_group(x, y_hi, y_lo, yy_half, T: int, passes: int):
    """The operand checks every group form shares."""
    Q, d = x.shape
    M = y_hi.shape[0]
    if T % _LANES:
        raise ValueError(f"T={T} must be a multiple of {_LANES}")
    if M % T or M == 0:
        raise ValueError(f"index rows M={M} must be a whole number of "
                         f"T={T} tiles")
    if y_hi.shape[1] != d or yy_half.shape != (M,):
        raise ValueError("fused_l2_group_topk: operand shapes "
                         f"x {tuple(x.shape)}, y_hi {tuple(y_hi.shape)}, "
                         f"yy_half {tuple(yy_half.shape)} do not agree")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if passes == 3 and (y_lo is None or y_lo.shape != y_hi.shape):
        raise ValueError("passes=3 needs y_lo shaped like y_hi")


def _check(x, y_hi, y_lo, yy_half, T: int, g: int, passes: int,
           pair: bool, pbits: int):
    _check_group(x, y_hi, y_lo, yy_half, T, passes)
    if not 0 < pbits <= _PBITS_MAX:
        raise ValueError(f"pbits={pbits} outside (0, {_PBITS_MAX}]")
    if g * (T // _LANES) > (1 << pbits):
        raise ValueError(
            f"packed group kernel: g*T/128 = {g * T // _LANES} exceeds "
            f"the {1 << pbits}-code packing envelope")
    if pair and (T // _LANES) % 2:
        raise ValueError(f"pair=True requires an even chunk count, got "
                         f"T/128 = {T // _LANES}")


def fused_l2_group_topk_packed(x, y_hi, y_lo, yy_half, *, T: int, g: int,
                               passes: int, pair: bool = False,
                               pbits: int = _PACK_BITS, xxh=None
                               ) -> Tuple[torch.Tensor, ...]:
    """Per (query, bucket) the two smallest and the third smallest packed
    half-scores ``(yy/2 − x·y) + xx/2``.

    x [Q, d] f32; y_hi (and y_lo at passes=3) [M, d] bf16 (the
    :func:`split_hi_lo` of the index); yy_half [M] f32 holding ‖y‖²/2, and
    ``_PACK_PAD`` on padded rows; xxh [Q] f32 query half-norms (None: 0).
    M is a whole number of T-row tiles; a bucket is (lane class, group of
    ``g`` tiles). Returns ``(a1p, a2p, a3p)``, each [Q, ceil(M/T/g)·128]
    f32, whose low ``pbits`` mantissa bits hold the within-group code
    ``tile_offset·(T/128) + chunk`` (a3p's code means nothing). ``pair``
    min-combines chunk pairs before the fold (reference ``:697``). d is
    at most 512 (the resident query block; past it
    :func:`fused_l2_group_topk_packed_dchunk`)."""
    global LAUNCHES
    _check(x, y_hi, y_lo, yy_half, T, g, passes, pair, pbits)
    _check_resident("fused_l2_group_topk_packed", x)
    if x.device.type == "cpu":
        return fused_l2_group_topk_packed_ref(
            x, y_hi, y_lo, yy_half, T=T, g=g, passes=passes, pair=pair,
            pbits=pbits, xxh=xxh)
    y_lo, xxh = _cuda_operands("fused_l2_group_topk_packed", x, y_hi, y_lo,
                               yy_half, xxh)
    Q, d = x.shape
    M = y_hi.shape[0]
    outs = _outputs(x, Q, M, T, g, 3)
    if Q == 0:
        return tuple(outs)
    with torch.cuda.device(x.device):
        rc = _launcher()(
            x.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
            yy_half.data_ptr(), xxh.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), Q, M, d, T, g, passes,
            int(pair), pbits, torch.cuda.current_stream().cuda_stream)
    _raise_on("fused_l2_group_topk_packed", rc)
    LAUNCHES += 1
    return tuple(outs)


def _check_resident(who: str, x):
    """The packed kernels keep the query block in shared memory: d ≤
    ``_D_RESIDENT``."""
    if x.shape[1] > _D_RESIDENT:
        raise ValueError(
            f"{who}: the resident query block takes d ≤ {_D_RESIDENT} (got "
            f"d={x.shape[1]}); past it use "
            f"fused_l2_group_topk_packed_dchunk")


def _cuda_operands(who: str, x, y_hi, y_lo, yy_half, xxh):
    """The checks of a CUDA launch of a group form: a CUDA device,
    d % 128, contiguous operands of the kernel's types. Returns (y_lo,
    xxh) with their defaults filled in (y_lo is never read at passes=1;
    xxh None is zeros)."""
    if x.device.type != "cuda":
        raise DeviceError(f"{who}: no kernel for device {x.device}")
    Q, d = x.shape
    if d % _LANES:
        raise ValueError(f"the Hopper kernel needs d % {_LANES} == 0 "
                         f"(knn_fused pads features), got d={d}")
    if xxh is None:
        xxh = torch.zeros((Q,), dtype=torch.float32, device=x.device)
    xxh = xxh.reshape(Q)
    if y_lo is None:
        y_lo = y_hi
    for name, t, dt in (("x", x, torch.float32),
                        ("y_hi", y_hi, torch.bfloat16),
                        ("y_lo", y_lo, torch.bfloat16),
                        ("yy_half", yy_half, torch.float32),
                        ("xxh", xxh, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous {dt} "
                             f"tensor on {x.device}")
    return y_lo, xxh


def _outputs(x, Q: int, M: int, T: int, g: int, n: int):
    S = -(-(M // T) // g) * _LANES
    return [torch.empty((Q, S), dtype=torch.float32, device=x.device)
            for _ in range(n)]


def _raise_on(who: str, rc: int):
    if rc:
        raise DeviceError(f"{who}: launch failed with CUDA error {rc}")


def _split_x(x, passes: int):
    """The streamed forms' query operand: bf16 hi (and lo) of x, rounded
    as the resident kernel and the twins round it, zero rows padded to
    whole 64-query blocks."""
    Q, d = x.shape
    pad = (-Q) % 64
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
    hi, lo = split_hi_lo(x)
    return hi, (lo if passes == 3 else hi)


def fused_l2_group_topk_packed_dchunk(x, y_hi, y_lo, yy_half, *, T: int,
                                      g: int, passes: int,
                                      pair: bool = False,
                                      pbits: int = _PACK_BITS, xxh=None
                                      ) -> Tuple[torch.Tensor, ...]:
    """Wide-feature form of :func:`fused_l2_group_topk_packed` (the
    reference's ``_packed_dchunk``, ``:1294``): the same contract and
    outputs for any d (a multiple of 128 on the card). On the card the
    query block is resident or streams beside y, and clusters of query
    blocks share y, as the launcher picks (:func:`dchunk_geometry`)."""
    global LAUNCHES_DCHUNK
    _check(x, y_hi, y_lo, yy_half, T, g, passes, pair, pbits)
    if x.device.type == "cpu":
        return fused_l2_group_topk_packed_dchunk_ref(
            x, y_hi, y_lo, yy_half, T=T, g=g, passes=passes, pair=pair,
            pbits=pbits, xxh=xxh)
    who = "fused_l2_group_topk_packed_dchunk"
    y_lo, xxh = _cuda_operands(who, x, y_hi, y_lo, yy_half, xxh)
    Q, d = x.shape
    M = y_hi.shape[0]
    outs = _outputs(x, Q, M, T, g, 3)
    if Q == 0:
        return tuple(outs)
    x_hi, x_lo = _split_x(x, passes)
    with torch.cuda.device(x.device):
        rc = _launcher_dchunk()(
            x_hi.data_ptr(), x_lo.data_ptr(), y_hi.data_ptr(),
            y_lo.data_ptr(), yy_half.data_ptr(), xxh.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), Q,
            M, d, T, g, passes, int(pair), pbits,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(who, rc)
    LAUNCHES_DCHUNK += 1
    return tuple(outs)


def dchunk_geometry(Q: int, d: int, passes: int) -> Tuple[bool, int, int]:
    """The geometry (queries resident, ring stages, query blocks a cluster)
    that :func:`fused_l2_group_topk_packed_dchunk` takes for Q queries of d
    features on the current CUDA device (``pick_wide_geo`` in
    ``csrc/fused_l2_packed_sm90.cu``)."""
    fn = _build.load(
        "fused_l2_packed_sm90").fused_l2_group_topk_packed_dchunk_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    _raise_on("dchunk_geometry", fn(Q, d, passes, out))
    return bool(out[0]), out[1], out[2]


def fused_l2_group_topk_packed_dchunk_ref(x, y_hi, y_lo, yy_half, *,
                                          T: int, g: int, passes: int,
                                          pair: bool = False,
                                          pbits: int = _PACK_BITS,
                                          xxh=None):
    """Plain PyTorch twin of :func:`fused_l2_group_topk_packed_dchunk`:
    the resident form's twin (the products do not depend on how d is
    cut; only the f32 summation order does)."""
    return fused_l2_group_topk_packed_ref(
        x, y_hi, y_lo, yy_half, T=T, g=g, passes=passes, pair=pair,
        pbits=pbits, xxh=xxh)


def group_segments(Q: int, n_groups: int, chunks: int, n_sm: int) -> int:
    """Segments each group of the unpacked form is cut into. One block
    runs an SM, so ``blocks·S`` blocks take ⌈blocks·S / n_sm⌉ whole waves:
    1 when the (64-query block, group) blocks already fill the card; else
    the fewest S ≤ min(chunks, ⌈4·n_sm / blocks⌉) whose waves keep 90% of
    the SMs busy (or the busiest). Fewer segments merge fewer partial
    states: on the card one full wave beat two (PERF.md §6)."""
    blocks = -(-Q // 64) * n_groups
    if blocks >= n_sm:
        return 1

    def busy(S):
        return blocks * S / (n_sm * -(-blocks * S // n_sm))

    top = max(1, min(chunks, -(-4 * n_sm // blocks)))
    fits = [S for S in range(1, top + 1) if busy(S) >= 0.9]
    return fits[0] if fits else max(range(1, top + 1),
                                    key=lambda S: (busy(S), -S))


def _group(x, y_hi, y_lo, yy_half, T: int, g: int, passes: int,
           xs: bool, segments=None, keep_part: bool = False):
    """Launch the unpacked form, resident (xs False) or streamed x, over
    ``segments`` segments a group (None: :func:`group_segments`). With
    ``keep_part`` returns (the outputs, the segments' summaries as
    :func:`merge_segments` takes them, or None at one segment)."""
    who = "fused_l2_group_topk_dchunk" if xs else "fused_l2_group_topk"
    y_lo, _ = _cuda_operands(who, x, y_hi, y_lo, yy_half, None)
    Q, d = x.shape
    M = y_hi.shape[0]
    a1, a2, a3, id1, id2 = _outputs(x, Q, M, T, g, 5)
    id1, id2 = id1.view(torch.int32), id2.view(torch.int32)
    chunks = min(g, M // T) * (T // _LANES)
    if segments is None:
        n_sm = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        segments = group_segments(Q, a1.shape[1] // _LANES, chunks, n_sm)
    if not 1 <= segments <= chunks:
        raise ValueError(f"{who}: segments={segments} outside [1, "
                         f"{chunks}] (the chunks of a group)")
    out = (a1, id1, a2, id2, a3)
    part = None
    if segments > 1:
        part = torch.empty((6, segments, Q, a1.shape[1]),
                           dtype=torch.float32, device=x.device)
    if Q > 0:
        x_hi, x_lo = _split_x(x, passes) if xs else (x, x)
        with torch.cuda.device(x.device):
            rc = _launcher_group()(
                x.data_ptr(), x_hi.data_ptr(), x_lo.data_ptr(),
                y_hi.data_ptr(), y_lo.data_ptr(), yy_half.data_ptr(),
                a1.data_ptr(), id1.data_ptr(), a2.data_ptr(), id2.data_ptr(),
                a3.data_ptr(), 0 if part is None else part.data_ptr(), Q, M,
                d, T, g, passes, int(xs), segments,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(who, rc)
    if not keep_part:
        return out
    if part is not None:
        part = tuple(part[k].view(torch.int32) if k in (1, 3, 4)
                     else part[k] for k in range(6))
    return out, part


def fused_l2_group_topk(x, y_hi, y_lo, yy_half, *, T: int, g: int,
                        passes: int, segments=None
                        ) -> Tuple[torch.Tensor, ...]:
    """The unpacked fold (reference ``fused_l2_group_topk``, ``:1230``):
    per (query, bucket) the two smallest half-scores ``yy/2 − x·y`` with
    their global row ids, and the third smallest, for geometries whose
    g·T/128 codes do not fit the packed mantissa. yy_half carries +inf on
    padded rows (never wins; a bucket of pads keeps +inf and id −1); there
    is no query norm: callers recover d2 as 2·a + ‖x‖². Returns ``(a1,
    id1, a2, id2, a3)``, each [Q, ceil(M/T/g)·128] (ids int32).

    On the card, ``segments`` cuts each group's chunks into that many
    contiguous segments folded apart and merged in segment order (None:
    as many as fill the card, :func:`group_segments`; 1: one block a
    group); every count gives the same bits, so the CPU twin ignores
    it."""
    global LAUNCHES_GROUP
    _check_group(x, y_hi, y_lo, yy_half, T, passes)
    if x.device.type == "cpu":
        return fused_l2_group_topk_ref(x, y_hi, y_lo, yy_half, T=T, g=g,
                                       passes=passes)
    out = _group(x, y_hi, y_lo, yy_half, T, g, passes, False, segments)
    LAUNCHES_GROUP += 1
    return out


def fused_l2_group_topk_dchunk(x, y_hi, y_lo, yy_half, *, T: int, g: int,
                               passes: int, segments=None
                               ) -> Tuple[torch.Tensor, ...]:
    """Wide-feature form of :func:`fused_l2_group_topk` (reference
    ``:1254``): the same outputs, x's feature slices streamed beside
    y's as in :func:`fused_l2_group_topk_packed_dchunk`; ``segments`` as
    there."""
    global LAUNCHES_GROUP_DCHUNK
    _check_group(x, y_hi, y_lo, yy_half, T, passes)
    if x.device.type == "cpu":
        return fused_l2_group_topk_dchunk_ref(x, y_hi, y_lo, yy_half, T=T,
                                              g=g, passes=passes)
    out = _group(x, y_hi, y_lo, yy_half, T, g, passes, True, segments)
    LAUNCHES_GROUP_DCHUNK += 1
    return out


def _scores(x, y_hi, y_lo, passes: int):
    """[Q, M] x·y, the bf16-factor products summed in f32 by
    ``torch.matmul`` (the twins' contraction): hi·hi, then + hi·lo, then
    + lo·hi at passes=3."""
    xhi = x.to(torch.bfloat16)
    s = xhi.float() @ y_hi.float().T
    if passes == 3:
        xlo = (x - xhi.float()).to(torch.bfloat16)
        s = s + xhi.float() @ y_lo.float().T
        s = s + xlo.float() @ y_hi.float().T
    return s


def _half_scores(x, y_hi, y_lo, yy_half, passes: int):
    """[Q, M] ``yy/2 − x·y`` over the twins' contraction."""
    return _scores(x, y_hi, y_lo, passes).neg_().add_(yy_half[None, :])


def fused_l2_group_topk_ref(x, y_hi, y_lo, yy_half, *, T: int, g: int,
                            passes: int):
    """Plain PyTorch twin of :func:`fused_l2_group_topk`: the twins'
    contraction, then :func:`_group_fold`. The kernel's test oracle and
    the CPU path."""
    _check_group(x, y_hi, y_lo, yy_half, T, passes)
    return _group_fold(_half_scores(x, y_hi, y_lo, yy_half, passes), T, g)


def fused_l2_group_topk_dchunk_ref(x, y_hi, y_lo, yy_half, *, T: int,
                                   g: int, passes: int):
    """Plain PyTorch twin of :func:`fused_l2_group_topk_dchunk` (the
    resident form's twin)."""
    return fused_l2_group_topk_ref(x, y_hi, y_lo, yy_half, T=T, g=g,
                                   passes=passes)


def _group_geometry(c, T: int, g: int):
    """The half-scores ``c`` [Q, M] as [Q, n_groups, cpg, 128] chunks (a
    partial last group padded with +inf chunks, which change nothing),
    and each group's first global row id per lane, [n_groups, 128]."""
    Q, M = c.shape
    n_chunks = M // _LANES
    n_groups = -(-(M // T) // g)
    cpg = g * (T // _LANES) if n_groups > 1 else n_chunks
    pad = n_groups * cpg * _LANES - M
    if pad:
        c = torch.cat([c, c.new_full((Q, pad), float("inf"))], dim=1)
    col = (torch.arange(n_groups, device=c.device)[:, None] * cpg
           * _LANES + torch.arange(_LANES, device=c.device)[None, :]
           ).to(torch.int32)
    return c.reshape(Q, n_groups, cpg, _LANES), col


def _merge_ids(cr, ci, a1, id1, a2, id2, a3):
    """One entry (value ``cr``, id ``ci``) into the state with
    ``_merge_chunk_top2``'s compare/selects: strict < (on a tie the
    earlier entry stays), the displaced entry into a NaN-propagating
    a3."""
    lt1 = cr < a1
    b1 = torch.where(lt1, a1, cr)
    bid1 = torch.where(lt1, id1, ci)
    a1 = torch.where(lt1, cr, a1)
    id1 = torch.where(lt1, ci, id1)
    lt2 = b1 < a2
    b2 = torch.where(lt2, a2, b1)
    a2 = torch.where(lt2, b1, a2)
    id2 = torch.where(lt2, bid1, id2)
    return a1, id1, a2, id2, torch.minimum(a3, b2)


def _group_fold(c, T: int, g: int):
    """The unpacked fold of the [Q, M] half-scores ``c`` in chunk order,
    with ``_merge_chunk_top2``'s compare/selects (strict <: on a tie the
    earlier id stays) and a NaN-propagating a3. Chunks past the last
    tile are skipped (a +inf chunk changes nothing)."""
    Q = c.shape[0]
    c, col = _group_geometry(c, T, g)
    a1 = c.new_full((Q, c.shape[1], _LANES), float("inf"))
    a2, a3 = a1.clone(), a1.clone()
    id1 = torch.full(a1.shape, -1, dtype=torch.int32, device=c.device)
    id2 = id1.clone()
    for r in range(c.shape[2]):
        ci = (col + r * _LANES).expand_as(id1)
        a1, id1, a2, id2, a3 = _merge_ids(c[:, :, r], ci, a1, id1, a2, id2,
                                          a3)
    S = c.shape[1] * _LANES
    return tuple(a.reshape(Q, S) for a in (a1, id1, a2, id2, a3))


def merge_segments(parts):
    """The merge of split groups (the kernel's second pass) in plain
    torch. ``parts`` = (e1, i1, e2, i2, i3, r), each [segs, ...]: each
    segment's :func:`_fold_segment` summary. The sequential fold's ids
    depend only on the first two arrivals of the smallest value and of
    the second smallest and on their order, and every such entry is
    among the segments' candidates (e1, i1), (e2, i2) and, where i3 ≥ 0,
    (e2, i3). So the fold's compare/selects run over each segment's
    candidates in arrival (id) order, segment after segment, give its
    (a1, id1, a2, id2) bit for bit; a3 is that run's a3 NaN-min every
    segment's r (which holds all its other entries)."""
    e1, i1, e2, i2, i3, r = parts
    inf = torch.tensor(float("inf"), device=e1.device)
    big = torch.tensor(torch.iinfo(torch.int32).max, dtype=torch.int32,
                       device=e1.device)
    a1 = torch.full_like(e1[0], float("inf"))
    a2, a3 = a1.clone(), a1.clone()
    id1 = torch.full_like(i1[0], -1)
    id2 = id1.clone()
    for k in range(e1.shape[0]):
        tie = i3[k] >= 0
        cand = [(e1[k], i1[k]), (e2[k], i2[k]),
                (torch.where(tie, e2[k], inf), torch.where(tie, i3[k], big))]
        for p, q in ((0, 1), (1, 2), (0, 1)):      # sort the three by id
            sw = cand[q][1] < cand[p][1]
            lo = tuple(torch.where(sw, u, v) for u, v in zip(cand[q],
                                                              cand[p]))
            hi = tuple(torch.where(sw, v, u) for u, v in zip(cand[q],
                                                              cand[p]))
            cand[p], cand[q] = lo, hi
        for cv, ci in cand:
            a1, id1, a2, id2, a3 = _merge_ids(cv, ci, a1, id1, a2, id2, a3)
        a3 = torch.minimum(a3, r[k])
    return a1, id1, a2, id2, a3


def _fold_segment(c, col, r0: int, r1: int):
    """One segment's summary, chunks [r0, r1) of ``c`` [Q, G, cpg, 128]
    in arrival order: its two (value, arrival)-smallest entries (e1, i1),
    (e2, i2) (strict <: a later equal entry never passes an earlier one;
    +inf and −1 where there are fewer), i3 the id of the third smallest
    where its value equals e2's (else −1), and r the NaN-propagating min
    of every other entry's value (the third's included). Returns (e1, i1,
    e2, i2, i3, r), each [Q, G, 128]."""
    e1 = c.new_full((c.shape[0], c.shape[1], _LANES), float("inf"))
    e2, r = e1.clone(), e1.clone()
    i1 = torch.full(e1.shape, -1, dtype=torch.int32, device=c.device)
    i2, i3 = i1.clone(), i1.clone()
    none = torch.tensor(-1, dtype=torch.int32, device=c.device)
    for k in range(r0, r1):
        cr = c[:, :, k]
        ci = (col + k * _LANES).expand_as(i1)
        lt1 = cr < e1
        lt2 = cr < e2
        r = torch.minimum(r, torch.where(lt2, e2, cr))
        i3 = torch.where(lt1, torch.where(e1 == e2, i2, none),
                         torch.where(lt2, none, torch.where(
                             (cr == e2) & (i3 < 0), ci, i3)))
        i2 = torch.where(lt1, i1, torch.where(lt2, ci, i2))
        e2 = torch.where(lt1, e1, torch.where(lt2, cr, e2))
        i1 = torch.where(lt1, ci, i1)
        e1 = torch.where(lt1, cr, e1)
    return e1, i1, e2, i2, i3, r


def _group_fold_split(c, T: int, g: int, segments: int):
    """The split twin of :func:`_group_fold`, cut as the kernel cuts a
    group: segment k of a group of n chunks (the last group counts its
    real tiles only) takes chunks [⌊n·k/segs⌋, ⌊n·(k+1)/segs⌋) and is
    summarized by :func:`_fold_segment`; then :func:`merge_segments`.
    Returns (the outputs, the summaries, each [segs, Q, n_groups·128])."""
    Q, M = c.shape
    c, col = _group_geometry(c, T, g)
    G, cpg = c.shape[1], c.shape[2]
    n_tiles = M // T
    parts = [[] for _ in range(6)]
    for k in range(segments):
        seg = [[] for _ in range(6)]
        for grp in range(G):
            n = min(g, n_tiles - grp * g) * (T // _LANES) if G > 1 else cpg
            st = _fold_segment(c[:, grp:grp + 1], col[grp:grp + 1],
                               n * k // segments, n * (k + 1) // segments)
            for j in range(6):
                seg[j].append(st[j])
        for j in range(6):
            parts[j].append(torch.cat(seg[j], dim=1).reshape(Q, G * _LANES))
    parts = tuple(torch.stack(p) for p in parts)
    S = G * _LANES
    return tuple(a.reshape(Q, S) for a in merge_segments(parts)), parts


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load(
            "fused_l2_packed_sm90").fused_l2_group_topk_packed_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launcher_dchunk():
    global _FN_DCHUNK
    if _FN_DCHUNK is None:
        fn = _build.load(
            "fused_l2_packed_sm90").fused_l2_group_topk_packed_dchunk_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN_DCHUNK = fn
    return _FN_DCHUNK


def _launcher_group():
    global _FN_GROUP
    if _FN_GROUP is None:
        fn = _build.load("fused_l2_topk").fused_l2_group_topk_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN_GROUP = fn
    return _FN_GROUP


def _pack(c: torch.Tensor, code, pbits: int) -> torch.Tensor:
    """Replace the low ``pbits`` mantissa bits of ``c`` by ``code``."""
    bits = c.view(torch.int32) & ~((1 << pbits) - 1)
    return (bits | code).view(torch.float32)


def _merge(cp, a1, a2, a3):
    """The reference's 5-op packed merge (``_merge_chunk_top2_packed``)."""
    b1 = torch.maximum(a1, cp)
    a1 = torch.minimum(a1, cp)
    b2 = torch.maximum(a2, b1)
    a2 = torch.minimum(a2, b1)
    a3 = torch.minimum(a3, b2)
    return a1, a2, a3


def fused_l2_group_topk_packed_ref(x, y_hi, y_lo, yy_half, *, T: int,
                                   g: int, passes: int, pair: bool = False,
                                   pbits: int = _PACK_BITS, xxh=None):
    """Plain PyTorch twin of :func:`fused_l2_group_topk_packed`: the
    same bf16-factor products summed in f32 by ``torch.matmul``, then the
    chunked, packed fold in the reference's order. The kernel's test
    oracle and the CPU path."""
    _check(x, y_hi, y_lo, yy_half, T, g, passes, pair, pbits)
    c = _half_scores(x, y_hi, y_lo, yy_half, passes)
    if xxh is not None:
        c += xxh.reshape(-1, 1)
    return _packed_fold(c, T, g, pair, pbits)


def _packed_fold(c, T: int, g: int, pair: bool, pbits: int):
    """The chunked, packed fold of the [Q, M] half-scores ``c`` in the
    reference's order (shared by both twins)."""
    Q, M = c.shape
    n_ch = T // _LANES
    n_groups = -(-(M // T) // g)
    pad = n_groups * g * T - M
    if pad:
        # a partial last group: sentinel chunks lose every comparison
        # against the _PACK_PAD initial state, as skipped chunks would
        c = torch.cat([c, c.new_full((Q, pad), _PACK_PAD)], dim=1)
    c = c.reshape(Q, n_groups, g * n_ch, _LANES)
    a1 = c.new_full((Q, n_groups, _LANES), _PACK_PAD)
    a2, a3 = a1.clone(), a1.clone()
    if pair:
        for r in range(0, g * n_ch, 2):
            c0, c1 = c[:, :, r], c[:, :, r + 1]
            mn = torch.minimum(c0, c1)
            a3 = torch.minimum(a3, torch.maximum(c0, c1))
            code = torch.where(mn == c1, r + 1, r).to(torch.int32)
            a1, a2, a3 = _merge(_pack(mn, code, pbits), a1, a2, a3)
    else:
        for r in range(g * n_ch):
            a1, a2, a3 = _merge(_pack(c[:, :, r].contiguous(), r, pbits),
                                a1, a2, a3)
    S = n_groups * _LANES
    return a1.reshape(Q, S), a2.reshape(Q, S), a3.reshape(Q, S)


# ---------------------------------------------------------------- K2 (int8)
def _check_q8(x, y_q, yy_half, scale, T: int, g: int, passes: int,
              pair: bool, pbits: int):
    Q, d = x.shape
    M = y_q.shape[0]
    if T % _LANES:
        raise ValueError(f"T={T} must be a multiple of {_LANES}")
    if M % (g * T) or M == 0:
        raise ValueError(f"int8 index rows M={M} must be a whole number "
                         f"of g·T = {g * T}-row groups")
    if y_q.dtype != torch.int8:
        raise ValueError(f"y_q must be int8, got {y_q.dtype}")
    if (y_q.shape[1] != d or yy_half.shape != (M,)
            or scale.shape != (M // (g * T),)):
        raise ValueError("fused_l2_group_topk_packed_q8: operand shapes "
                         f"x {tuple(x.shape)}, y_q {tuple(y_q.shape)}, "
                         f"yy_half {tuple(yy_half.shape)}, scale "
                         f"{tuple(scale.shape)} do not agree")
    # y_lo does not exist here: the passes / pair / envelope checks are K1's
    _check(x, y_q, y_q, yy_half, T, g, passes, pair, pbits)


def fused_l2_group_topk_packed_q8(x, y_q, yy_half, scale, *, T: int,
                                  g: int, passes: int, pair: bool = False,
                                  pbits: int = _PACK_BITS, xxh=None
                                  ) -> Tuple[torch.Tensor, ...]:
    """K2: :func:`fused_l2_group_topk_packed` over an int8 database.

    y_q [M, d] int8 is the per-group symmetric quantization of the
    streamed rows (M a whole number of g·T-row groups); scale [M/(g·T)]
    f32 holds one scale per group; yy_half [M] the dequantized rows'
    half-norms (``_PACK_PAD`` on pads). The contraction is bf16(x)·q (plus
    bf16(x − bf16(x))·q at passes=3) in f32, times the group's scale once
    the d-sum is done. Outputs, codes and ``pair`` are K1's; d is at most
    512, as for K1."""
    global LAUNCHES_Q8
    _check_q8(x, y_q, yy_half, scale, T, g, passes, pair, pbits)
    _check_resident("fused_l2_group_topk_packed_q8", x)
    if x.device.type == "cpu":
        return fused_l2_group_topk_packed_q8_ref(
            x, y_q, yy_half, scale, T=T, g=g, passes=passes, pair=pair,
            pbits=pbits, xxh=xxh)
    if x.device.type != "cuda":
        raise DeviceError(f"fused_l2_group_topk_packed_q8: no kernel for "
                          f"device {x.device}")
    Q, d = x.shape
    M = y_q.shape[0]
    if d % _LANES:
        raise ValueError(f"the Hopper kernel needs d % {_LANES} == 0 "
                         f"(knn_fused pads features), got d={d}")
    if xxh is None:
        xxh = torch.zeros((Q,), dtype=torch.float32, device=x.device)
    xxh = xxh.reshape(Q)
    for name, t, dt in (("x", x, torch.float32),
                        ("y_q", y_q, torch.int8),
                        ("yy_half", yy_half, torch.float32),
                        ("scale", scale, torch.float32),
                        ("xxh", xxh, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_l2_group_topk_packed_q8: {name} must "
                             f"be a contiguous {dt} tensor on {x.device}")
    S = M // (g * T) * _LANES
    outs = [torch.empty((Q, S), dtype=torch.float32, device=x.device)
            for _ in range(3)]
    if Q == 0:
        return tuple(outs)
    with torch.cuda.device(x.device):
        rc = _launcher_q8()(
            x.data_ptr(), y_q.data_ptr(), scale.data_ptr(),
            yy_half.data_ptr(), xxh.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), Q, M, d, T, g, passes,
            int(pair), pbits, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"fused_l2_group_topk_packed_q8: launch failed "
                          f"with CUDA error {rc}")
    LAUNCHES_Q8 += 1
    return tuple(outs)


def _launcher_q8():
    global _FN_Q8
    if _FN_Q8 is None:
        fn = _build.load(
            "fused_l2_packed_sm90").fused_l2_group_topk_packed_q8_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN_Q8 = fn
    return _FN_Q8


def fused_l2_group_topk_packed_q8_ref(x, y_q, yy_half, scale, *, T: int,
                                      g: int, passes: int,
                                      pair: bool = False,
                                      pbits: int = _PACK_BITS, xxh=None):
    """Plain PyTorch twin of :func:`fused_l2_group_topk_packed_q8`:
    ``bf16(x)·q`` (+ the x-lo product at passes=3) by ``torch.matmul`` in
    f32, times the group's scale, then K1's packed fold. The kernel's test
    oracle and the CPU path."""
    _check_q8(x, y_q, yy_half, scale, T, g, passes, pair, pbits)
    Q = x.shape[0]
    xhi = x.to(torch.bfloat16)
    qf = y_q.float().T
    s = xhi.float() @ qf
    if passes == 3:
        xlo = (x - xhi.float()).to(torch.bfloat16)
        s += xlo.float() @ qf
    del qf
    s *= scale.repeat_interleave(g * T)[None, :]
    c = s.neg_().add_(yy_half[None, :])           # yy/2 − scale·(x·q)
    if xxh is not None:
        c += xxh.reshape(Q, 1)
    return _packed_fold(c, T, g, pair, pbits)


# ------------------------------------------------------------ slot forms
def _check_slot(who: str, x, y_hi, y_lo, xx, yy, T: int, Qb: int,
                passes: int, dc=None):
    """The reference's ``_check_tiling`` (``:362``) and, for the
    d-chunked form, its ``d % dc`` check (``:485``), in its order and
    words; then the operand shapes. ``Qb`` lays out the TPU grid only, so
    it is checked and not used."""
    if T % _LANES:
        raise ValueError(f"T={T} must be a multiple of {_LANES}")
    if Qb % 8:
        raise ValueError(f"Qb={Qb} must be a multiple of 8")
    Q, d = x.shape
    M = y_hi.shape[0]
    if dc is not None and d % dc:
        raise ValueError(
            f"fused_l2_slot_topk_dchunk: d={d} must be a multiple of "
            f"dc={dc} (the tail would be silently dropped)")
    if M % T or M == 0:
        raise ValueError(f"index rows M={M} must be a whole number of "
                         f"T={T} tiles")
    if y_hi.shape[1] != d or xx.numel() != Q or yy.numel() != M:
        raise ValueError(f"{who}: operand shapes x {tuple(x.shape)}, y_hi "
                         f"{tuple(y_hi.shape)}, xx {tuple(xx.shape)}, yy "
                         f"{tuple(yy.shape)} do not agree")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if passes == 3 and (y_lo is None or y_lo.shape != y_hi.shape):
        raise ValueError("passes=3 needs y_lo shaped like y_hi")


def fused_l2_slot_topk(x, y_hi, y_lo, xx, yy, m_real, *, T: int, Qb: int,
                       passes: int, mask: bool = True, track: bool = True
                       ) -> Tuple[torch.Tensor, ...]:
    """K1's slot form (reference ``fused_l2_slot_topk``, ``:406``): per
    slot, a (tile of T rows, lane = row % 128) bucket, the smallest
    ``d2 = (xx + yy) − 2·x·y`` and its global row id, and per (query,
    lane) the min over tiles of each slot's second smallest.

    x [Q, d] f32; y_hi (and y_lo at passes=3) [M, d] bf16, M a whole
    number of T-row tiles; xx [Q] (or [Q, 1]) and yy [M] (or [1, M])
    exact f32 squared norms; m_real (an int or a one-element tensor) the
    real row count: with ``mask`` every row ≥ m_real scores +inf. Returns
    ``(m1 [Q, S] f32, i1 [Q, S] int32, m2min [Q, 128] f32)``, S = (M/T)·128,
    slot s = (tile s // 128, lane s % 128); a slot of pads keeps +inf and
    −1. ``track=False`` is the reference's measurement-only min fold:
    i1 = 0 and m2min the min over tiles of the slot minima."""
    _check_slot("fused_l2_slot_topk", x, y_hi, y_lo, xx, yy, T, Qb, passes)
    if x.device.type == "cpu":
        return fused_l2_slot_topk_ref(x, y_hi, y_lo, xx, yy, m_real, T=T,
                                      Qb=Qb, passes=passes, mask=mask,
                                      track=track)
    if x.shape[1] > _D_RESIDENT:
        raise ValueError(
            f"fused_l2_slot_topk: the resident query block takes d ≤ "
            f"{_D_RESIDENT} (got d={x.shape[1]}); past it use "
            f"fused_l2_slot_topk_dchunk")
    return _slot("fused_l2_slot_topk", x, y_hi, y_lo, xx, yy, m_real, T,
                 passes, mask, track, False)


def fused_l2_slot_topk_dchunk(x, y_hi, y_lo, xx, yy, m_real, *, T: int,
                              Qb: int, passes: int, dc: int = 256
                              ) -> Tuple[torch.Tensor, ...]:
    """Wide-feature form of :func:`fused_l2_slot_topk` (reference
    ``:474``): the same outputs, always masked and tracked; d must be a
    multiple of ``dc`` (the reference's padding contract). On the card
    x's feature slices stream beside y's, as in
    :func:`fused_l2_group_topk_packed_dchunk`."""
    _check_slot("fused_l2_slot_topk_dchunk", x, y_hi, y_lo, xx, yy, T, Qb,
                passes, dc)
    if x.device.type == "cpu":
        return fused_l2_slot_topk_dchunk_ref(x, y_hi, y_lo, xx, yy, m_real,
                                             T=T, Qb=Qb, passes=passes,
                                             dc=dc)
    return _slot("fused_l2_slot_topk_dchunk", x, y_hi, y_lo, xx, yy,
                 m_real, T, passes, True, True, True)


def slot_tiles_per_block(Q: int, n_tiles: int, n_sm: int) -> int:
    """Tiles of one block of the slot kernels: the tiles are cut into
    enough groups that the 64-query blocks fill the card about eight
    times over (each group writes one [Q, 128] partial of m2min)."""
    n_groups = min(n_tiles, max(1, -(-8 * n_sm // -(-Q // 64))))
    return -(-n_tiles // n_groups)


def _slot(who: str, x, y_hi, y_lo, xx, yy, m_real, T: int, passes: int,
          mask: bool, track: bool, xs: bool):
    """Launch a slot form: resident x (xs False) or streamed x, and count
    the launch."""
    global LAUNCHES_SLOT, LAUNCHES_SLOT_DCHUNK
    if x.device.type != "cuda":
        raise DeviceError(f"{who}: no kernel for device {x.device}")
    Q, d = x.shape
    M = y_hi.shape[0]
    if d % _LANES:
        raise ValueError(f"the Hopper kernel needs d % {_LANES} == 0, got "
                         f"d={d}")
    xx, yy = xx.reshape(Q), yy.reshape(M)
    if y_lo is None:
        y_lo = y_hi
    for name, t, dt in (("x", x, torch.float32),
                        ("y_hi", y_hi, torch.bfloat16),
                        ("y_lo", y_lo, torch.bfloat16),
                        ("xx", xx, torch.float32), ("yy", yy, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous {dt} "
                             f"tensor on {x.device}")
    n_tiles = M // T
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tpb = slot_tiles_per_block(Q, n_tiles, n_sm)
    dev = x.device
    m1 = torch.empty((Q, n_tiles * _LANES), dtype=torch.float32, device=dev)
    i1 = torch.empty((Q, n_tiles * _LANES), dtype=torch.int32, device=dev)
    m2min = torch.empty((Q, _LANES), dtype=torch.float32, device=dev)
    if Q == 0:
        return m1, i1, m2min
    part = torch.empty((-(-n_tiles // tpb), Q, _LANES), dtype=torch.float32,
                       device=dev)
    m_real = min(int(m_real), M)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if xs:
            x_hi, x_lo = _split_x(x, passes)
            rc = _launcher_slot(True)(
                x_hi.data_ptr(), x_lo.data_ptr(), y_hi.data_ptr(),
                y_lo.data_ptr(), xx.data_ptr(), yy.data_ptr(),
                m1.data_ptr(), i1.data_ptr(), part.data_ptr(),
                m2min.data_ptr(), Q, M, d, T, tpb, m_real, passes, stream)
        else:
            rc = _launcher_slot(False)(
                x.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
                xx.data_ptr(), yy.data_ptr(), m1.data_ptr(), i1.data_ptr(),
                part.data_ptr(), m2min.data_ptr(), Q, M, d, T, tpb, m_real,
                passes, int(mask), int(track), stream)
    _raise_on(who, rc)
    if xs:
        LAUNCHES_SLOT_DCHUNK += 1
    else:
        LAUNCHES_SLOT += 1
    return m1, i1, m2min


def _launcher_slot(xs: bool):
    fn = _FN_SLOT.get(xs)
    if fn is None:
        lib = _build.load("fused_l2_topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        if xs:
            fn = lib.fused_l2_slot_topk_dchunk_launch
            fn.argtypes = [p] * 10 + [i] * 7 + [p]
        else:
            fn = lib.fused_l2_slot_topk_launch
            fn.argtypes = [p] * 9 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
        _FN_SLOT[xs] = fn
    return fn


def fused_l2_slot_topk_ref(x, y_hi, y_lo, xx, yy, m_real, *, T: int,
                           Qb: int, passes: int, mask: bool = True,
                           track: bool = True):
    """Plain PyTorch twin of :func:`fused_l2_slot_topk`: the reference's
    ``_fused_kernel`` and ``_fold_and_write`` (``:238-299``) over the
    twins' contraction. The kernel's test oracle and the CPU path."""
    _check_slot("fused_l2_slot_topk", x, y_hi, y_lo, xx, yy, T, Qb, passes)
    Q, M = x.shape[0], y_hi.shape[0]
    d2 = xx.reshape(Q, 1) + yy.reshape(1, M)
    d2.sub_(_scores(x, y_hi, y_lo, passes), alpha=2.0)  # (xx + yy) − 2·s
    return _slot_fold(d2, T, int(m_real), mask, track)


def fused_l2_slot_topk_dchunk_ref(x, y_hi, y_lo, xx, yy, m_real, *,
                                  T: int, Qb: int, passes: int,
                                  dc: int = 256):
    """Plain PyTorch twin of :func:`fused_l2_slot_topk_dchunk` (the
    resident form's twin, masked and tracked: the products do not depend
    on how d is cut, only the f32 summation order does)."""
    _check_slot("fused_l2_slot_topk_dchunk", x, y_hi, y_lo, xx, yy, T, Qb,
                passes, dc)
    return fused_l2_slot_topk_ref(x, y_hi, y_lo, xx, yy, m_real, T=T,
                                  Qb=Qb, passes=passes)


def _slot_fold(d2, T: int, m_real: int, mask: bool, track: bool):
    """The reference's per-slot fold of the [Q, M] distances ``d2`` (in
    place), chunk by chunk in ascending order. Tracked: strict < (on a
    tie the earlier row stays), a2 through a NaN-propagating minimum,
    which a later new minimum displaces. Min-only: a NaN-propagating
    minimum, i1 = 0, a2 = a1. m2min is the NaN-propagating min over
    tiles of a2."""
    Q, M = d2.shape
    if mask:
        d2.masked_fill_(torch.arange(M, device=d2.device)[None, :]
                        >= m_real, float("inf"))
    n_tiles = M // T
    c = d2.view(Q, n_tiles, T // _LANES, _LANES)
    a1 = d2.new_full((Q, n_tiles, _LANES), float("inf"))
    if not track:
        for r in range(T // _LANES):
            a1 = torch.minimum(a1, c[:, :, r])
        a2 = a1
        i1 = torch.zeros(a1.shape, dtype=torch.int32, device=d2.device)
    else:
        a2 = a1.clone()
        i1 = torch.full(a1.shape, -1, dtype=torch.int32, device=d2.device)
        col = (torch.arange(n_tiles, device=d2.device)[:, None] * T
               + torch.arange(_LANES, device=d2.device)[None, :]
               ).to(torch.int32)                          # [tiles, 128]
        for r in range(T // _LANES):
            cr = c[:, :, r]
            lt1 = cr < a1
            a2 = torch.where(lt1, a1, torch.minimum(a2, cr))
            a1 = torch.where(lt1, cr, a1)
            i1 = torch.where(lt1, col + r * _LANES, i1)
    S = n_tiles * _LANES
    return a1.reshape(Q, S), i1.reshape(Q, S), torch.amin(a2, dim=1)


def split_hi_lo(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 → bf16 hi + bf16 lo with y ≈ hi + lo, both rounded to nearest
    (the bf16x3 operand prep; the dropped lo·lo term is O(2⁻¹⁸·‖x‖‖y‖)).
    PyTorch runs the conversions as written, so the reference's
    optimization barrier has no counterpart here."""
    y = y.float()
    hi = y.to(torch.bfloat16)
    lo = (y - hi.float()).to(torch.bfloat16)
    return hi, lo
