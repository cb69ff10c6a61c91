"""Per-device peak figures the cost models price work against.

Counterpart of ``raft_tpu/utils/arch.py`` (``ChipSpec`` at ``:38``,
``CPU_SPEC`` and ``chip_spec``). The reference keys a table of TPU
generations; the port runs on one card type, the H100 SXM, and on the
CPU. Every figure of :data:`H100_SPEC` is a spec-sheet figure (NVIDIA's
H100 SXM5 datasheet), not a measurement of this repo: 989 TFLOP/s dense
bf16, 67 TFLOP/s f32 (non-tensor-core), 3.35 TB/s HBM3, 80 GB, and
NVLink 4 at 900 GB/s bidirectional, i.e. 450 GB/s one way, with a
per-round latency estimate. Two rates the reference has no use for price
the port's unexpanded-distance kernel: ``issue_f32``, FP32 instructions
a second (132 SMs × 128 lanes × 1.98 GHz), and ``sfu``, the special
function unit's reciprocals a second (an eighth of that). :data:`CPU_SPEC` carries the reference's
synthetic CPU figures unchanged, so a ``merge="auto"`` choice on the CPU
is the reference's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one device (reference ``:38``): ``peak_flops`` dense
    bf16 matmul FLOP/s, ``peak_flops_f32`` f32-grade FLOP/s, ``hbm_bw``
    and ``hbm_bytes`` device memory bytes/s and bytes, ``ici_bw`` the
    aggregate one-way device-to-device rate in bytes/s (the wire term of
    :func:`raft_tpu_torch.observability.costmodel.ici_time_model`),
    ``ici_latency`` the fixed seconds a collective round costs, and
    ``issue_f32`` / ``sfu`` the FP32-instruction and SFU rates a cost
    record with ``rate="fp32_issue"`` / ``"sfu"`` is priced at (0 means
    ``peak_flops_f32``)."""

    name: str
    peak_flops: float
    peak_flops_f32: float
    hbm_bw: float
    hbm_bytes: float
    ici_bw: float = 0.0
    ici_latency: float = 1e-6
    issue_f32: float = 0.0
    sfu: float = 0.0

    @property
    def ridge(self) -> float:
        """FLOP/byte where the bf16 roofline goes flat."""
        return self.peak_flops / self.hbm_bw

    @property
    def ridge_f32(self) -> float:
        return self.peak_flops_f32 / self.hbm_bw


_T = 1e12
_G = 1e9

#: FP32 instructions a second: 132 SMs × 128 lanes × 1.98 GHz
_H100_ISSUE = 132 * 128 * 1.98e9

#: NVIDIA H100 SXM5 80 GB, spec-sheet figures (see the module doc); the
#: 5 µs round latency is an estimate of one NCCL round on NVLink, not a
#: measurement
H100_SPEC = ChipSpec("nvidia h100 sxm (spec sheet)", 989 * _T, 67 * _T,
                     3350 * _G, 80 * _G, ici_bw=450 * _G, ici_latency=5e-6,
                     issue_f32=_H100_ISSUE, sfu=_H100_ISSUE / 8)

#: the reference's synthetic CPU figures (reference ``:101``)
CPU_SPEC = ChipSpec("cpu (synthetic roofline)", 200 * _G, 100 * _G,
                    25 * _G, 64 * _G, ici_bw=5 * _G, ici_latency=2e-6)


def chip_spec(device=None) -> ChipSpec:
    """The figures of ``device``: :data:`H100_SPEC` for a CUDA device
    (the one card the port targets), :data:`CPU_SPEC` otherwise. With no
    device, a CUDA device when one is visible."""
    if device is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        kind = torch.device(device).type
    return H100_SPEC if kind == "cuda" else CPU_SPEC
