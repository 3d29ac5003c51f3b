"""Reference polyphase synthesis filterbank — ISO 11172-3 §2.4.3.2.2.

Straight-from-spec V-FIFO formulation in float64. This is the ground
truth for the device kernel's FIR reformulation (tables/filterbank.py
synthesis_fir) and for bit-exactness tests.
"""
from __future__ import annotations

import numpy as np


class SynthFIFO:
    """Stateful per-channel synthesis: 32 subband samples -> 32 PCM."""

    def __init__(self, channels: int):
        from ..tables import filterbank as fb
        self.N = fb.synthesis_matrix()
        self.D = fb.synthesis_window()
        self.V = np.zeros((channels, 1024))

    _U_IDX = None

    @classmethod
    def _u_idx(cls) -> np.ndarray:
        if cls._U_IDX is None:
            idx = np.arange(512)
            blk, j = idx // 64, idx % 64
            cls._U_IDX = np.where(j < 32, blk * 128 + j, blk * 128 + 64 + j)
        return cls._U_IDX

    def step(self, S: np.ndarray) -> np.ndarray:
        """S: [channels, 32] subband samples -> [channels, 32] PCM."""
        V = self.V
        V[:, 64:] = V[:, :-64]
        V[:, :64] = S @ self.N.T
        W = V[:, self._u_idx()] * self.D[None, :]
        return W.reshape(-1, 16, 32).sum(axis=1)

    def step_one(self, ch: int, S32: np.ndarray) -> np.ndarray:
        """Single-channel step (oracle granule path)."""
        V = self.V
        V[ch, 64:] = V[ch, :-64]
        V[ch, :64] = self.N @ S32
        W = V[ch, self._u_idx()] * self.D
        return W.reshape(16, 32).sum(axis=0)
