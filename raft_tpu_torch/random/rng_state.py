"""RNG state vocabulary of the port (counterpart of
``raft_tpu/random/rng_state.py``; ref: cpp/include/raft/random/
rng_state.hpp:19-40 ``GeneratorType{GenPhilox, GenPC}`` and
``RngState{seed, base_subsequence, type}``).

A state is a seed and a subsequence that seed a ``torch.Generator`` on the
target device: on a card that generator is Philox4x32-10, the reference's
own ``GenPhilox``, counter-based like the TPU's threefry (``THREEFRY`` is
kept as an alias of ``PHILOX``). Subsequence 0 seeds the generator with
the seed itself, so ``RngState(s)`` draws what an int seed ``s`` draws; a
later subsequence seeds it with a SplitMix64 mix of the two. ``PCG`` is
the reference's bit-compatible PCG32 stream, served by ``uniform`` only
(``rng.pcg32_uniform``).
"""

from __future__ import annotations

import enum

import torch

from raft_tpu_torch.core.resources import resolve_device

_MASK64 = (1 << 64) - 1


class GeneratorType(enum.Enum):
    """(ref: rng_state.hpp:19 ``GeneratorType``)"""

    PHILOX = "philox"     # the device's counter-based generator
    THREEFRY = "philox"   # alias: the reference's name for that role
    PCG = "pcg"           # host-side PCG32 stream (bit-compatible)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class RngState:
    """(ref: rng_state.hpp:29 ``RngState{seed, base_subsequence, type}``)"""

    def __init__(self, seed: int = 0, base_subsequence: int = 0,
                 type: GeneratorType = GeneratorType.PHILOX):  # noqa: A002
        self.seed = int(seed)
        self.base_subsequence = int(base_subsequence)
        self.type = type

    def generator_seed(self) -> int:
        """The 64-bit seed of this state's generator."""
        if not self.base_subsequence:
            return self.seed & _MASK64
        return _splitmix64(self.seed ^ _splitmix64(self.base_subsequence))

    def generator(self, device=None) -> torch.Generator:
        """A ``torch.Generator`` on ``device`` (cuda by default) seeded
        from this state."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(self.generator_seed())
        return gen

    def advance(self, n_subsequences: int = 1) -> "RngState":
        """Advance the stream. (ref: rng_state.hpp ``advance``)"""
        self.base_subsequence += int(n_subsequences)
        return self

    def split(self) -> "RngState":
        """A fresh state on an independent subsequence (this one
        advances past it)."""
        self.advance()
        return RngState(self.seed, self.base_subsequence, self.type)

    def __repr__(self):
        return (f"RngState(seed={self.seed}, "
                f"base_subsequence={self.base_subsequence}, "
                f"type={self.type.name})")


def target_device(res, device=None, state=None) -> torch.device:
    """Where a generator draws: ``device``, else the handle's, else the
    device of a ``torch.Generator`` state, else cuda."""
    if device is None and res is not None:
        device = res.device
    if device is None and isinstance(state, torch.Generator):
        device = state.device
    return resolve_device(device)


def as_generator(state, res, device: torch.device) -> torch.Generator:
    """The ``torch.Generator`` a distribution draws from: ``state`` itself
    when it is one, the handle's own for None, else one seeded from an
    ``RngState`` or an int seed. A PCG state is refused here: only
    ``uniform`` implements the PCG stream, and drawing from another
    generator instead would break the bit-parity contract."""
    if isinstance(state, torch.Generator):
        return state
    if state is None:
        return res.generator
    if isinstance(state, RngState):
        if state.type == GeneratorType.PCG:
            raise NotImplementedError(
                "GeneratorType.PCG is only supported by random.uniform(); "
                "use THREEFRY for other distributions")
        return state.generator(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen
