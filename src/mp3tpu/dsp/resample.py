"""Rational polyphase resampler (SURVEY.md D2) — e.g. 44.1k -> 48k (147:160).

The windowed-sinc prototype is designed once in float64 (Kaiser
window), then resampling is one strided `lax.conv_general_dilated` —
dense device work, no per-sample Python.
Streaming state is the filter tail (explicit, checkpoint-friendly).
"""
from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _rational(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g  # L (up), M (down)


@lru_cache(maxsize=None)
def design_filter(L: int, M: int, taps_per_phase: int = 24,
                  beta: float = 12.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype, length L*taps_per_phase (float64)."""
    n = L * taps_per_phase
    cutoff = min(1.0 / L, 1.0 / M)  # in units of the upsampled Nyquist
    t = np.arange(n) - (n - 1) / 2.0
    h = cutoff * np.sinc(cutoff * t) * np.kaiser(n, beta)
    return h * (L / h.sum())  # unity passband gain after L-fold dilation


class Resampler:
    """Streaming rational resampler for PCM [n, ch] float32.

    The naive formulation (input-dilate by L, stride by M) spends most
    of its work on the zero-stuffed lattice. The resampling operator
    is block-Toeplitz: every M input samples (+ state_len of context)
    produce exactly L output samples through one constant [L, M+state_len]
    matrix W[o, j] = h[n_taps-1 - (j*L - o*M)]. That is a plain strided
    conv with L output features and NO input dilation — a dense matrix
    product per block (equal math up to summation order)."""

    def __init__(self, sr_in: int, sr_out: int, taps_per_phase: int = 24):
        self.sr_in, self.sr_out = sr_in, sr_out
        self.L, self.M = _rational(sr_in, sr_out)
        h = design_filter(self.L, self.M, taps_per_phase)
        self.n_taps = len(h)
        self.kernel = jnp.asarray(h, jnp.float32)
        self.state_len = self.n_taps // self.L  # input samples of history
        # block matrix: width covers the largest input index any of the
        # L outputs in a block reads
        width = ((self.L - 1) * self.M + self.n_taps - 1) // self.L + 1
        W = np.zeros((self.L, width), np.float64)
        for o in range(self.L):
            for j in range(width):
                k = j * self.L - o * self.M
                if 0 <= k < self.n_taps:
                    W[o, j] = h[self.n_taps - 1 - k]
        self.block_w = jnp.asarray(W, jnp.float32)  # [L, width]
        self.block_width = width

    def init_state(self, channels: int):
        """Streaming state: (carry samples, inputs seen, outputs emitted).

        The carry holds every input sample any future output still
        reads — including the fractional-block leftover, so chained
        calls with ARBITRARY chunk sizes continue the exact output grid
        of a one-shot resample (no per-chunk phase reset: output blocks
        are emitted only in whole L-sized groups, each consuming
        exactly M inputs, so the block matrix's phase is always 0)."""
        return (jnp.zeros((self.state_len, channels), jnp.float32), 0, 0)

    def __call__(self, pcm, state=None):
        """Resample PCM [n, ch] -> ([m, ch], new_state). Streaming-exact:
        concatenating the outputs of chained calls (+ flush) equals the
        one-shot output bit-for-bit, for any chunking."""
        ch = pcm.shape[1]
        if state is None:
            state = self.init_state(ch)
        carry, n_in, n_out = state
        x = jnp.concatenate([carry, pcm], axis=0)
        N = x.shape[0]
        # whole blocks whose full input window is present: all L outputs
        # of such a block are exact (zero-padding can't reach them)
        nblk = max(0, (N - self.block_width) // self.M + 1)
        if nblk == 0:
            return jnp.zeros((0, ch), jnp.float32), (x, n_in + pcm.shape[0], n_out)
        need = (nblk - 1) * self.M + self.block_width
        lhs = x[:need].T[:, None, :]                # [ch, 1, need]
        rhs = self.block_w[:, None, :]              # [L, 1, width]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(self.M,), padding=[(0, 0)],
            precision=jax.lax.Precision.HIGHEST)    # [ch, L, nblk]
        y = out.transpose(0, 2, 1).reshape(ch, -1).T
        new_state = (x[nblk * self.M:], n_in + pcm.shape[0],
                     n_out + nblk * self.L)
        return y, new_state

    def total_out(self, n_in: int) -> int:
        """One-shot output count for n_in input samples (the dilate-by-L
        / stride-by-M formulation's length)."""
        N = self.state_len + n_in
        return ((N - 1) * self.L + 1 - self.n_taps) // self.M + 1

    def flush(self, state):
        """Drain the tail: zero-pad the carry and emit the outputs that
        complete the one-shot length. Returns [m_tail, ch]."""
        carry, n_in, n_out = state
        remaining = self.total_out(n_in) - n_out
        if remaining <= 0:
            return jnp.zeros((0, carry.shape[1]), jnp.float32)
        nblk = -(-remaining // self.L)
        npad = (nblk - 1) * self.M + self.block_width
        xp = jnp.pad(carry, ((0, max(0, npad - carry.shape[0])), (0, 0)))
        ch = carry.shape[1]
        lhs = xp[:npad].T[:, None, :]
        rhs = self.block_w[:, None, :]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(self.M,), padding=[(0, 0)],
            precision=jax.lax.Precision.HIGHEST)
        return out.transpose(0, 2, 1).reshape(ch, -1)[:, :remaining].T


def resample(pcm, sr_in: int, sr_out: int):
    """One-shot resample of PCM [n, ch]."""
    if sr_in == sr_out:
        return pcm
    r = Resampler(sr_in, sr_out)
    pcm = jnp.asarray(pcm, jnp.float32)
    out, st = r(pcm)
    return jnp.concatenate([out, r.flush(st)], axis=0)
