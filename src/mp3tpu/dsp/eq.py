"""Graphic EQ (SURVEY.md D4).

Design decision (SURVEY.md §7.4): FIR, not biquad IIR — IIR is a
per-sample sequential recurrence and therefore hostile to batched
device work; a frequency-sampled linear-phase FIR applies as one
convolution and is exactly checkpointable via its overlap tail.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_BANDS = (31.0, 62.0, 125.0, 250.0, 500.0, 1000.0,
                 2000.0, 4000.0, 8000.0, 16000.0)


@lru_cache(maxsize=None)
def design_fir(band_gains_db: tuple, sample_rate: int, n_taps: int = 511) -> np.ndarray:
    """Linear-phase FIR via frequency sampling of a log-interpolated
    10-band target response (float64)."""
    bands = np.asarray(DEFAULT_BANDS)
    gains = np.asarray(band_gains_db, np.float64)
    nyq = sample_rate / 2.0
    n_fft = n_taps + 1
    freqs = np.linspace(0, nyq, n_fft // 2 + 1)
    logf = np.log10(np.maximum(freqs, 1.0))
    target_db = np.interp(logf, np.log10(bands), gains,
                          left=gains[0], right=gains[-1])
    mag = 10.0 ** (target_db / 20.0)
    # linear phase: real, even impulse response
    full = np.concatenate([mag, mag[-2:0:-1]])
    h = np.real(np.fft.ifft(full))
    h = np.roll(h, n_taps // 2)[:n_taps]
    h *= np.hanning(n_taps)
    return h


class GraphicEQ:
    """Streaming 10-band graphic EQ for PCM [n, ch]."""

    def __init__(self, band_gains_db, sample_rate: int, n_taps: int = 511):
        self.h = jnp.asarray(design_fir(tuple(band_gains_db), sample_rate, n_taps),
                             jnp.float32)
        self.n_taps = n_taps

    def init_state(self, channels: int):
        return jnp.zeros((self.n_taps - 1, channels), jnp.float32)

    def __call__(self, pcm, state=None):
        ch = pcm.shape[1]
        if state is None:
            state = self.init_state(ch)
        x = jnp.concatenate([state, pcm], axis=0)
        lhs = x.T[:, None, :]
        rhs = self.h[None, None, ::-1]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(1,), padding="VALID",
            precision=jax.lax.Precision.HIGHEST)
        return out[:, 0, :].T, x[-(self.n_taps - 1):]
