"""Bitset and bitmap views of the port, as far as the sparse layer needs
them (``sparse/convert.py``'s ``bitmap_to_csr`` / ``bitset_to_csr``, for
``masked_matmul``).

(Counterpart of ``raft_tpu/core/bitset.py``; ref: cpp/include/raft/core/
bitset.hpp:33 ``bitset_view``, core/bitmap.hpp:34 ``bitmap_view``.) The
words are the reference's ``uint32`` words, held as an int32 tensor of the
same bits (torch has no full uint32 arithmetic); bit ``i`` is bit
``i % 32`` of word ``i // 32``.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device

_WORD_BITS = 32


def _words_tensor(words, device=None) -> torch.Tensor:
    if isinstance(words, torch.Tensor):
        return words.to(torch.int32)
    w = np.ascontiguousarray(np.asarray(words).astype(np.uint32))
    return torch.from_numpy(w.view(np.int32).copy()).to(
        resolve_device(device))


class BitsetView:
    """Non-owning view over a words array. (ref: core/bitset.hpp:33)"""

    def __init__(self, words, n_bits: int, device=None):
        self.words = _words_tensor(words, device)
        self.n_bits = int(n_bits)

    def test(self, indices) -> torch.Tensor:
        """Bit values at ``indices`` as a bool tensor.
        (ref: bitset.hpp ``bitset_view::test``)"""
        idx = torch.as_tensor(indices, device=self.words.device).long()
        word = self.words[idx // _WORD_BITS].long()
        return ((word >> (idx % _WORD_BITS)) & 1).bool()

    def to_dense(self) -> torch.Tensor:
        """All bits as a bool vector of length n_bits."""
        return self.test(torch.arange(self.n_bits,
                                      device=self.words.device))

    def count(self) -> torch.Tensor:
        """Number of set bits. (ref: util/popc.cuh + bitset::count)"""
        return self.to_dense().sum().to(torch.int32)

    @classmethod
    def from_dense(cls, bits, device=None) -> "BitsetView":
        """Pack a bool vector into words (bit i → word i // 32)."""
        dev = resolve_device(device, bits)
        b = torch.as_tensor(bits, device=dev).bool()
        n = b.shape[0]
        pad = -n % _WORD_BITS
        b = torch.cat([b, b.new_zeros(pad)]) if pad else b
        weights = torch.ones(_WORD_BITS, dtype=torch.int64, device=dev) \
            << torch.arange(_WORD_BITS, device=dev)
        w = (b.view(-1, _WORD_BITS).long() * weights).sum(1)
        w = torch.where(w >= 1 << 31, w - (1 << 32), w)   # uint32 bits
        return cls(w.to(torch.int32), n)


class BitmapView:
    """2-D bitmap view over a bitset words array, rows×cols bit matrix.
    (ref: core/bitmap.hpp:34)"""

    def __init__(self, words, n_rows: int, n_cols: int, device=None):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self._bitset = BitsetView(words, self.n_rows * self.n_cols, device)
        self.words = self._bitset.words

    def test(self, rows, cols) -> torch.Tensor:
        dev = self.words.device
        rows = torch.as_tensor(rows, device=dev).long()
        cols = torch.as_tensor(cols, device=dev).long()
        return self._bitset.test(rows * self.n_cols + cols)

    def to_dense(self) -> torch.Tensor:
        return self._bitset.to_dense().reshape(self.n_rows, self.n_cols)

    def count(self) -> torch.Tensor:
        return self._bitset.count()

    @classmethod
    def from_dense(cls, mat, device=None) -> "BitmapView":
        dev = resolve_device(device, mat)
        m = torch.as_tensor(mat, device=dev).bool()
        bs = BitsetView.from_dense(m.reshape(-1))
        return cls(bs.words, m.shape[0], m.shape[1])
