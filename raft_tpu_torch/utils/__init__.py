"""raft_tpu_torch.utils — the card's roofline and interconnect figures."""

from raft_tpu_torch.utils.arch import CPU_SPEC, H100_SPEC, ChipSpec, chip_spec

__all__ = ["CPU_SPEC", "H100_SPEC", "ChipSpec", "chip_spec"]
