"""List-major IVF-PQ ADC scan (K5): wrapper, plain twin and constants.

Counterpart of ``raft_tpu/ops/pq_scan_pallas.py``. The TPU kernel
``pq_scan_list_major`` (``:279``) becomes the hand-written Hopper kernel in
``csrc/pq_scan.cu``; see that file for the design.

The contract (the reference's): for every schedule entry ``j`` with
``(start, lsize, off, lid) = sched[:, j]``, every query whose probe table
holds ``lid`` is scored against the window columns ``[off, off+lsize)``
of the codes slab rows ``start .. start+Wk`` by table lookup,

    d2 = ((xx + ‖ŷ‖²) − 2·cdot[q, j]) − 2·Σ_s lut[q, s·K + code_s]

and the certified lower bound ``lb = max(√max(d2, 0) − Eq_row, 0)²``
folds into the query's 128 slots (slot = column % 128) as the top
``pool_depth`` (value, global slab row) pairs plus a running rest-min.
Slots where nothing was scored read (+inf, −1). The reference evaluates
the table sum as a bf16 hi/lo one-hot product; the port gathers the f32
table entries and sums them in a fixed order of its own (:func:`adc_sum`;
tighter: see ``ann/ivf_pq.py`` for the certificate envelope that covers
both, in any order of the S terms).

The wrapper dispatches on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.fine_scan import LISTS_PER_CELL, _members

_LANES = 128

#: supported code widths: 4-bit codes pack two per byte
PQ_BITS = (4, 8)

#: supported pool depths (top-N per slot): 2 is the base 256-slot pool,
#: 4 and 8 the widen rungs (512 and 1024 slots)
PQ_POOL_DEPTHS = (2, 4, 8)

#: shared memory one block of the kernel may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448

# kernel launches since import (or since a caller reset them), one per
# wrapper call that launched, by code width, and by pool depth (the base
# pool and the widen rungs)
LAUNCHES_8BIT = 0
LAUNCHES_4BIT = 0
LAUNCHES_DEPTH = {depth: 0 for depth in (2, 4, 8)}

_FN = None


def _table_cols(terms: int) -> int:
    """Columns of the kernel's table: the terms, repeated up to 32 where
    they are fewer and a power of 2 (so 32 lanes read 32 banks)."""
    return 32 if terms < 32 and terms & (terms - 1) == 0 else terms


def table_layout(pq_dim: int, pq_bits: int):
    """The kernel's table for one query: (pairs, terms, cols, smem bytes).
    A row's terms are its code bytes — an 8-bit code, or at 4 bits a pair
    of subspaces whose entry is the sum of the two subspaces' entries —
    over a table of 256 codes × cols, where that fits a block's shared
    memory; else (4-bit rows of more than ~450 subspaces) its nibbles, over
    16 codes × cols."""
    pq_dim, pq_bits = int(pq_dim), int(pq_bits)
    if pq_bits == 8:
        return False, pq_dim, _table_cols(pq_dim), \
            4 * 256 * _table_cols(pq_dim)
    pair_bytes = 4 * 256 * _table_cols(pq_dim // 2)
    if pair_bytes <= MAX_SMEM_BYTES:
        return True, pq_dim // 2, _table_cols(pq_dim // 2), pair_bytes
    return False, pq_dim, _table_cols(pq_dim), 4 * 16 * _table_cols(pq_dim)


def pq_scan_smem_bytes(pq_dim: int, pq_bits: int) -> int:
    """Shared memory of one block of the kernel: the query's table
    (:func:`table_layout`)."""
    return table_layout(pq_dim, pq_bits)[3]


def _check(sched, xx, probes, cdot, lut, codes, yy_pq, eq_rows, Wk: int,
           pq_bits: int, pool_depth: int) -> int:
    """The reference's checks (``:279-330``) and the port's shape checks;
    returns pq_dim."""
    if Wk <= 0 or Wk % _LANES:
        raise ValueError(f"pq_scan_list_major: Wk={Wk} must be a positive "
                         f"multiple of {_LANES}")
    if pq_bits not in PQ_BITS:
        raise ValueError(f"pq_scan_list_major: pq_bits must be one of "
                         f"{PQ_BITS}, got {pq_bits}")
    if pool_depth not in PQ_POOL_DEPTHS:
        raise ValueError(f"pq_scan_list_major: pool_depth must be one of "
                         f"{PQ_POOL_DEPTHS}, got {pool_depth}")
    if sched.ndim != 2 or sched.shape[0] != 4 or \
            sched.shape[1] % LISTS_PER_CELL:
        raise ValueError(f"pq_scan_list_major: sched must be [4, Lp] with "
                         f"Lp a multiple of {LISTS_PER_CELL}, got "
                         f"{tuple(sched.shape)}")
    nqp, Lp = xx.shape[0], sched.shape[1]
    if xx.numel() != nqp or probes.ndim != 2 or probes.shape[0] != nqp \
            or not 0 < probes.shape[1] <= _LANES:
        raise ValueError(f"pq_scan_list_major: xx {tuple(xx.shape)} and "
                         f"probes {tuple(probes.shape)} must cover the {nqp} "
                         f"queries, with 1..{_LANES} probe columns")
    if tuple(cdot.shape) != (nqp, Lp):
        raise ValueError(f"pq_scan_list_major: cdot {tuple(cdot.shape)} "
                         f"must be [{nqp}, {Lp}]")
    if codes.ndim != 2 or codes.dtype != torch.int8:
        raise ValueError(f"pq_scan_list_major: codes must be an int8 "
                         f"[R, code bytes] slab, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    R, cb = codes.shape
    pq_dim = cb if pq_bits == 8 else 2 * cb
    K = 1 << pq_bits
    if lut.ndim != 2 or tuple(lut.shape) != (nqp, pq_dim * K):
        raise ValueError(f"pq_scan_list_major: lut width "
                         f"{tuple(lut.shape)} != [{nqp}, pq_dim·K = "
                         f"{pq_dim * K}]")
    if yy_pq.numel() != R or eq_rows.numel() != R:
        raise ValueError(f"pq_scan_list_major: yy_pq {tuple(yy_pq.shape)} "
                         f"and eq_rows {tuple(eq_rows.shape)} must hold one "
                         f"value per slab row ({R})")
    smem = pq_scan_smem_bytes(pq_dim, pq_bits)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"pq_scan_list_major: the query's table of "
                         f"{pq_dim}x{K} f32 needs {smem} bytes of shared "
                         f"memory, over the {MAX_SMEM_BYTES} a block has")
    return pq_dim


def pq_scan_list_major(sched, xx, probes, cdot, lut, codes, yy_pq, eq_rows,
                       Wk: int, pq_bits: int = 8, pool_depth: int = 2):
    """List-major ADC scan over the product-quantized codes slab.

    sched [4, Lp] int32 (``build_list_schedule``: window start, list
    length, list offset in the window, list id; pads ``(0, 0, 0, −1)``);
    xx [nqp] or [nqp, 1] f32 query squared norms; probes [nqp, P ≤ 128]
    int32 (pads −2); cdot [nqp, Lp] f32 ``x · c_{lid(j)}``; lut
    [nqp, pq_dim·K] f32 with ``lut[q, s·K + j] = x_{q,s} · cb_s[j]``;
    codes [R, pq_dim] int8 biased (8-bit) or [R, pq_dim/2] packed nibbles
    (4-bit); yy_pq and eq_rows [R] or [R, 1] f32 (‖ŷ‖² and the recorded
    round-trip bound, pads 0). Returns ``(a_1, i_1, …, a_depth, i_depth,
    rest)``, each [nqp, 128] (f32 values, int32 global slab rows)."""
    global LAUNCHES_8BIT, LAUNCHES_4BIT
    _check(sched, xx, probes, cdot, lut, codes, yy_pq, eq_rows, Wk, pq_bits,
           pool_depth)
    if xx.device.type == "cpu":
        return pq_scan_list_major_ref(sched, xx, probes, cdot, lut, codes,
                                      yy_pq, eq_rows, Wk, pq_bits,
                                      pool_depth)
    out = _launch(sched, xx, probes, cdot, lut, codes, yy_pq, eq_rows, Wk,
                  pq_bits, pool_depth)
    if pq_bits == 8:
        LAUNCHES_8BIT += 1
    else:
        LAUNCHES_4BIT += 1
    LAUNCHES_DEPTH[pool_depth] += 1
    return out


def _launch(sched, xx, probes, cdot, lut, codes, yy_pq, eq_rows, Wk: int,
            pq_bits: int, depth: int):
    dev = xx.device
    if dev.type != "cuda":
        raise DeviceError(f"pq scan: no kernel for device {dev}")
    nqp = xx.shape[0]
    R, cb = codes.shape
    xx, yy, eq = xx.reshape(nqp), yy_pq.reshape(R), eq_rows.reshape(R)
    for name, t, dt in (("sched", sched, torch.int32),
                        ("xx", xx, torch.float32),
                        ("probes", probes, torch.int32),
                        ("cdot", cdot, torch.float32),
                        ("lut", lut, torch.float32),
                        ("codes", codes, torch.int8),
                        ("yy_pq", yy, torch.float32),
                        ("eq_rows", eq, torch.float32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"pq scan: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")
    Pp, Lp = probes.shape[1], sched.shape[1]
    pq_dim = cb if pq_bits == 8 else 2 * cb
    js, _, _ = _members(sched, probes)
    vals = torch.empty((depth, nqp, _LANES), dtype=torch.float32, device=dev)
    rows = torch.empty((depth, nqp, _LANES), dtype=torch.int32, device=dev)
    rest = torch.empty((nqp, _LANES), dtype=torch.float32, device=dev)
    pairs, terms, cols, _ = table_layout(pq_dim, pq_bits)
    vec = int(cb % 16 == 0 and cb // 16 in (1, 2, 4)
              and codes.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        rc = _launcher()(
            sched.data_ptr(), xx.data_ptr(), js.data_ptr(), cdot.data_ptr(),
            lut.data_ptr(), codes.data_ptr(), yy.data_ptr(), eq.data_ptr(),
            vals.data_ptr(), rows.data_ptr(), rest.data_ptr(), nqp, Pp, Lp,
            pq_dim, cb, R, Wk, pq_bits, depth, int(pairs), terms, cols, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"pq scan: launch failed with CUDA error {rc}")
    out = []
    for t in range(depth):
        out += [vals[t], rows[t]]
    return tuple(out) + (rest,)


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("pq_scan").pq_scan_list_major_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 13 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


# ------------------------------------------------------------ plain twin
def decode_codes(codes, pq_dim: int, pq_bits: int):
    """[R, pq_dim] int64 codes of a packed slab (reference
    ``_decode_subspaces``, ``:150``): 8-bit codes are stored biased, 4-bit
    codes two to a byte, low nibble = even subspace."""
    if pq_bits == 8:
        return codes.long() + 128
    vu = codes.view(torch.uint8).long()
    out = vu.new_empty((codes.shape[0], pq_dim))
    out[:, 0::2] = vu % 16
    out[:, 1::2] = vu // 16
    return out


def _order_span(terms: int) -> int:
    """The lanes over which the kernel spreads a row's terms (see
    :func:`adc_order`)."""
    if terms % 32 == 0 or terms & (terms - 1) == 0:
        return 32
    return terms & -terms


def adc_order(cols, terms: int):
    """The order in which the kernel takes a row's ``terms`` table terms
    (one a code byte: a subspace at 8 bits, a pair of subspaces at 4),
    [n, terms] term indices for the window columns ``cols`` [n]: the
    thread of column c is lane l = c % 32 of its warp, and its step i takes
    term (i ^ m) mod terms, m = l mod span, span = 32 where 32 divides
    ``terms`` or ``terms`` is a power of 2 (the table's columns then
    repeat the terms up to 32), else the largest power of 2 dividing it.
    At every step the lanes of a warp read different columns of the
    code-major table, so on the card different banks
    (``csrc/pq_scan.cu``)."""
    m = (cols.long() & 31) % _order_span(terms)
    return (torch.arange(terms, device=cols.device)[None, :]
            ^ m[:, None]) % terms


def adc_sum(lut, codes, cols, pq_dim: int, pq_bits: int):
    """The kernel's table sums, [nq, n], of the code rows ``codes`` [n,
    bytes] at window columns ``cols`` [n] for the tables ``lut`` [nq,
    pq_dim·2^bits]. A row's terms are :func:`table_layout`'s: its code
    bytes (at 8 bits the entry of one subspace, at 4 bits the f32 sum of
    its two subspaces' entries, low nibble first) or, for the widest 4-bit
    rows, its nibbles. Taken in :func:`adc_order`, the even steps and the
    odd steps are summed apart from 0.0 and then added, even first: two
    independent chains of adds a row."""
    K = 1 << pq_bits
    idx = decode_codes(codes, pq_dim, pq_bits) \
        + torch.arange(pq_dim, device=lut.device) * K       # [n, pq_dim]
    per = 2 if table_layout(pq_dim, pq_bits)[0] else 1
    idx = idx.reshape(idx.shape[0], -1, per)                   # [n, T, per]
    order = adc_order(cols, idx.shape[1])
    idx = idx.gather(1, order[:, :, None].expand(-1, -1, per))
    chains = [lut.new_zeros((lut.shape[0], idx.shape[0])) for _ in range(2)]
    for i in range(idx.shape[1]):
        v = lut[:, idx[:, i, 0]]
        if per == 2:
            v = v + lut[:, idx[:, i, 1]]
        chains[i % 2] = chains[i % 2] + v
    return chains[0] + chains[1]


def _fold_pool_deep(acc, c, ci, depth: int):
    """Fold one [n, 128] column chunk into ``depth``-deep pools (reference
    ``_fold_pool_deep``, ``:119``): ``acc`` is the list ``[a_1, i_1, …,
    a_depth, i_depth, rest]`` of the chunk's queries, updated in place."""
    a = acc[0:2 * depth:2]
    i = acc[1:2 * depth:2]
    lt = [c < a[t] for t in range(depth)]
    rest = torch.where(lt[depth - 1], a[depth - 1],
                       torch.where(c < acc[-1], c, acc[-1]))
    for t in range(depth - 1, 0, -1):
        a[t] = torch.where(lt[t - 1], a[t - 1], torch.where(lt[t], c, a[t]))
        i[t] = torch.where(lt[t - 1], i[t - 1], torch.where(lt[t], ci, i[t]))
    a[0] = torch.where(lt[0], c, a[0])
    i[0] = torch.where(lt[0], ci, i[0])
    acc[0:2 * depth:2] = a
    acc[1:2 * depth:2] = i
    acc[-1] = rest


def pq_scan_list_major_ref(sched, xx, probes, cdot, lut, codes, yy_pq,
                           eq_rows, Wk: int, pq_bits: int = 8,
                           pool_depth: int = 2):
    """Plain PyTorch twin of :func:`pq_scan_list_major`: the schedule
    walked entry by entry and each window 128 columns at a time, as the
    reference's kernel body does (``_pq_kernel_body``, ``:185``). A masked
    score is +inf and folds as a no-op, so each entry scores only its
    member queries and its live columns. The table sum is
    :func:`adc_sum`, the kernel's terms in the kernel's order, so the two
    agree bit for bit. The CPU path and the kernel's on-card oracle."""
    pq_dim = _check(sched, xx, probes, cdot, lut, codes, yy_pq, eq_rows, Wk,
                    pq_bits, pool_depth)
    nqp, dev = xx.shape[0], xx.device
    R = codes.shape[0]
    xx, yy, eq = xx.reshape(nqp), yy_pq.reshape(R), eq_rows.reshape(R)
    inf = torch.full((nqp, _LANES), float("inf"), device=dev)
    neg1 = torch.full((nqp, _LANES), -1, dtype=torch.int32, device=dev)
    acc = []
    for _ in range(pool_depth):
        acc += [inf.clone(), neg1.clone()]
    acc.append(inf.clone())
    lane = torch.arange(_LANES, device=dev)
    for j, (st, lsize, off, lid) in enumerate(sched.T.tolist()):
        mem = ((probes == lid) & (probes >= 0)).any(1).nonzero().squeeze(1)
        c_lo, c_hi = max(off, 0, -st), min(off + lsize, Wk, R - st)
        if mem.numel() == 0 or c_hi <= c_lo:
            continue
        cols = torch.arange(c_lo, c_hi, device=dev)
        rows = st + cols
        adc = adc_sum(lut[mem], codes[rows], cols, pq_dim, pq_bits)
        d2 = (xx[mem, None] + yy[rows][None, :]) \
            - 2.0 * cdot[mem, j][:, None] - 2.0 * adc
        v = (d2.clamp_min(0.0).sqrt() - eq[rows][None, :]).clamp_min(0.0)
        ch_lo, ch_hi = c_lo // _LANES, -(-c_hi // _LANES)
        full = v.new_full((mem.numel(), (ch_hi - ch_lo) * _LANES),
                          float("inf"))
        full[:, c_lo - ch_lo * _LANES:c_hi - ch_lo * _LANES] = v * v
        part = [t[mem] for t in acc]
        for r in range(ch_hi - ch_lo):
            ci = (st + (ch_lo + r) * _LANES + lane).to(torch.int32)
            _fold_pool_deep(part, full[:, r * _LANES:(r + 1) * _LANES],
                            ci[None, :], pool_depth)
        for t, p in zip(acc, part):
            t[mem] = p
    return tuple(acc)
