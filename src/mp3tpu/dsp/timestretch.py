"""Pitch-preserving time-stretch (phase vocoder) — the player's
"slow listening" control.

The reference's core usage pattern is repeat-listening language practice:
"play one article or a few sentences at a time, replay each sentence
repeatedly, slow listening" (reference README.md:46, SURVEY.md §0.1).
Loop/seek cover the replay half; this module covers the slow half —
tempo change WITHOUT pitch change (a plain resampler would turn a 440 Hz
voice into 330 Hz at 0.75x).

Batched device formulation:
- STFT/ISTFT are batched `jnp.fft.rfft/irfft` over fixed-size frame
  chunks — dense device work, no per-sample Python.
- Phase propagation is NOT a per-sample loop: the per-frame
  synthesis-phase increments depend only on CONSECUTIVE analysis phases
  (all known up front). With PHASE_LOCK=False it is one `jnp.cumsum`
  over the chunk's frames; the default identity-phase-locked path runs
  the same increments through a chunk-length `lax.scan` (8 steps per
  dispatch — the peak map makes the recursion frame-dependent), still
  zero per-bin sequential work.
- ONE compiled executable per channel count serves EVERY speed: the
  analysis hop `ha` is a traced scalar (frame extraction is a gather
  with computed indices; the expected-phase term `omega*ha mod 2pi` is
  exact int32 modular arithmetic), so turning the speed knob never
  recompiles — compile latency matters on this remote-compile backend.
- Streaming state is explicit and tiny (previous analysis phase,
  accumulated synthesis phase, overlap-add tail, host input residue):
  checkpoint-friendly (SURVEY.md §5.4) and chunking-invariant — feeding
  the same samples in any block sizes yields bit-identical output.

Quality: Laroche/Dolson vocoder with 4x-overlap periodic Hann
analysis/synthesis windows (exact WOLA constant 1.5) and IDENTITY
PHASE LOCKING — only spectral peaks propagate phase, other bins keep
their analysis-phase offset to the nearest peak — which preserves
vertical coherence (partials, transients) and suppresses the classic
unlocked-vocoder "phasiness". Channels are processed independently
(standard; slight stereo-image softening on strongly correlated
material is a known, accepted vocoder artifact).
"""
from __future__ import annotations

import math

import numpy as np

N_FFT = 2048          # analysis/synthesis window (46 ms @ 44.1 kHz)
HOP_SYN = N_FFT // 4  # synthesis hop (4x overlap -> WOLA constant 1.5)
F_CHUNK = 8           # frames per scan step (fixed jit shape)
C_SCAN = 8            # chunks per device dispatch (masked lax.scan)
SPEED_MIN = 0.25
SPEED_MAX = 4.0
PHASE_LOCK = True     # identity phase locking (trace-time; tests A/B it)
_HA_MAX = int(round(HOP_SYN * SPEED_MAX))
# fixed device input-buffer capacity: the last frame of the last scan
# chunk starts at (C_SCAN*F_CHUNK-1)*ha and spans N_FFT samples
_CAP = (C_SCAN * F_CHUNK - 1) * _HA_MAX + N_FFT
_SPAN = (F_CHUNK - 1) * _HA_MAX + N_FFT  # one chunk's input slice

_scan_jit = None


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _wrap(x):
    import jax.numpy as jnp
    two_pi = np.float32(2.0 * math.pi)
    return x - two_pi * jnp.round(x / two_pi)


def _chunk(buf, ha, prev_phase, acc_phase, tail, primed):
    """Stretch F_CHUNK frames from `buf` (first (F_CHUNK-1)*ha+N_FFT
    samples are live) into F_CHUNK*HOP_SYN output samples. All shapes
    static; `ha` is traced. Returns (emit, new_prev, new_acc, new_tail)."""
    import jax.numpy as jnp

    F, N, HS = F_CHUNK, N_FFT, HOP_SYN
    win = jnp.asarray(_hann(N), jnp.float32)
    b = jnp.arange(N // 2 + 1, dtype=jnp.int32)
    # omega_b * HS mod 2pi, exact: b*HS % N is integer arithmetic
    hs_mod = (2.0 * math.pi / N) * (b * HS % N).astype(jnp.float32)

    idx = jnp.arange(F, dtype=jnp.int32)[:, None] * ha \
        + jnp.arange(N, dtype=jnp.int32)[None, :]
    frames = jnp.take(buf, idx, axis=0)            # [F, N, ch]
    spec = jnp.fft.rfft(frames * win[None, :, None], axis=1)
    mag = jnp.abs(spec)                            # [F, B, ch]
    phase = jnp.arctan2(spec.imag, spec.real)

    # expected analysis-phase advance omega_b*ha mod 2pi, exact in int32
    # (b*ha <= (N/2)*HA_MAX < 2^22)
    expected = (2.0 * math.pi / N) * ((b * ha) % N).astype(jnp.float32)
    prev = jnp.concatenate([prev_phase[None], phase[:-1]], axis=0)
    dphi = _wrap(phase - prev - expected[None, :, None])
    ratio = jnp.float32(HS) / ha.astype(jnp.float32)
    inc = _wrap(hs_mod[None, :, None] + dphi * ratio)  # [F, B, ch]

    if PHASE_LOCK:
        # identity phase locking (Laroche/Dolson): only spectral PEAKS
        # propagate phase; every other bin keeps its ANALYSIS phase
        # offset to its nearest peak, so partials stay vertically
        # coherent and the classic vocoder "phasiness" (smeared
        # transients, hollow timbre) largely disappears. Peaks move
        # between frames, so the synthesis phase is a per-frame
        # recursion (an 8-step lax.scan), not a per-bin cumsum.
        from jax import lax
        B = N // 2 + 1
        idxs = jnp.arange(B, dtype=jnp.int32)[None, :, None]
        lower = jnp.full((F, 1, mag.shape[-1]), -1.0, mag.dtype)

        def sh(k):  # mag shifted k bins (out-of-range reads as -1)
            if k > 0:
                return jnp.concatenate([lower.repeat(k, 1),
                                        mag[:, :-k]], axis=1)
            return jnp.concatenate([mag[:, -k:], lower.repeat(-k, 1)],
                                   axis=1)

        is_peak = ((mag >= sh(1)) & (mag > sh(-1))
                   & (mag >= sh(2)) & (mag > sh(-2)))
        left = lax.cummax(jnp.where(is_peak, idxs, -1), axis=1)
        right = lax.cummin(jnp.where(is_peak, idxs, 2 * B), axis=1,
                           reverse=True)
        pick = jnp.where((idxs - left) <= (right - idxs), left, right)
        pick = jnp.where(left < 0, right, pick)
        pick = jnp.where(right >= 2 * B, jnp.maximum(left, 0), pick)
        p = jnp.clip(pick, 0, B - 1)
        anyp = is_peak.any(axis=1, keepdims=True)      # [F, 1, ch]
        phi_p = jnp.take_along_axis(phase, p, axis=1)
        inc_p = jnp.take_along_axis(inc, p, axis=1)
        first = jnp.concatenate([jnp.array([True]),
                                 jnp.zeros(F - 1, bool)])

        def step(theta_prev, xs):
            phi_k, phi_pk, inc_k, inc_pk, p_k, anyp_k, first_k = xs
            theta_pk = jnp.take_along_axis(theta_prev, p_k, axis=0) \
                + inc_pk
            theta = jnp.where(anyp_k, theta_pk + (phi_k - phi_pk),
                              theta_prev + inc_k)
            # stream start / post-seek: synthesis == analysis phase
            theta = jnp.where(first_k & ~primed, phi_k, theta)
            theta = _wrap(theta)
            return theta, theta

        new_acc, out_phase = lax.scan(
            step, acc_phase, (phase, phi_p, inc, inc_p, p, anyp, first))
    else:
        # plain per-bin propagation: one cumsum over the chunk's frames
        # (first frame unprimed -> synthesis phase = analysis phase)
        inc0 = jnp.where(primed, inc[0], _wrap(phase[0] - acc_phase))
        incs = jnp.concatenate([inc0[None], inc[1:]], axis=0)
        out_phase = acc_phase[None] + jnp.cumsum(incs, axis=0)
        new_acc = _wrap(out_phase[-1])

    y = jnp.fft.irfft(mag * jnp.exp(1j * out_phase), n=N, axis=1)
    y = y * (win[None, :, None] / 1.5)             # WOLA-normalized
    # overlap-add at hop HS: frame k covers output blocks k..k+3
    yb = y.reshape(F, 4, HS, -1)
    z = jnp.zeros((F + 3, HS, y.shape[-1]), jnp.float32)
    for j in range(4):
        z = z.at[j:j + F].add(yb[:, j])
    emit = z[:F].reshape(F * HS, -1)
    emit = emit.at[: N - HS].add(tail)
    new_tail = z[F:].reshape(N - HS, -1)
    return emit, phase[-1], new_acc, new_tail


def _chunk_scan(buf, ha, prev_phase, acc_phase, tail, primed, n_live):
    """Up to C_SCAN sequential chunks in ONE dispatch (masked lax.scan
    over _chunk). Every chunk — whether it arrives alone in a streaming
    trickle or among eight in a bulk drain — runs the SAME step of the
    SAME compiled program, so output stays bit-identical across input
    chunkings (XLA numerics are only stable within one executable);
    steps past `n_live` compute on padding and their state updates are
    masked out. Dispatch count drops ~C_SCAN-fold for bulk input while
    first-audio latency keeps the one-chunk requirement."""
    import jax.numpy as jnp
    from jax import lax

    def step(carry, c):
        prev, acc, tl, pr = carry
        live = c < n_live
        seg = lax.dynamic_slice(buf, (c * F_CHUNK * ha, 0),
                                (_SPAN, buf.shape[1]))
        emit, p2, a2, t2 = _chunk(seg, ha, prev, acc, tl, pr)
        keep = lambda new, old: jnp.where(live, new, old)
        return (keep(p2, prev), keep(a2, acc), keep(t2, tl),
                pr | live), emit

    (p, a, t, _), emits = lax.scan(
        step, (prev_phase, acc_phase, tail, primed),
        jnp.arange(C_SCAN, dtype=jnp.int32))
    return emits, p, a, t


class TimeStretch:
    """Streaming pitch-preserving tempo change for PCM [n, ch] float32.

    speed > 1 plays faster (shorter output), speed < 1 slower. The
    effective speed is quantized to ha/HOP_SYN (ha integer): at most
    ~0.2% off the request, exact for common values (0.5, 0.75, 1.25,
    1.5, 2.0).
    """

    def __init__(self, channels: int, speed: float = 1.0):
        self.channels = channels
        self._buf = np.zeros((0, channels), np.float32)
        self._prev_phase = None   # device [B, ch]
        self._acc_phase = None
        self._tail = None
        self._primed = False
        self.set_speed(speed)

    # ------------------------------------------------------------ state
    @property
    def speed(self) -> float:
        return self._ha / HOP_SYN

    def set_speed(self, speed: float):
        """Change tempo; takes effect at the next processed chunk —
        input already buffered (but not yet drained) is consumed at the
        NEW speed. Carried phase/overlap state is kept, so a mid-stream
        change glides without a click."""
        if not (SPEED_MIN <= speed <= SPEED_MAX):
            raise ValueError(
                f"speed must be in [{SPEED_MIN}, {SPEED_MAX}], got {speed}")
        self._ha = max(1, int(round(HOP_SYN * speed)))

    def reset(self):
        """Discontinuity (seek): drop buffered input and carried state."""
        self._buf = self._buf[:0]
        self._primed = False

    def state_blob(self) -> dict:
        """Host-serializable snapshot (SURVEY.md §5.4)."""
        d = {"ha": self._ha, "buf": self._buf, "primed": self._primed}
        if self._primed:
            d["prev"] = np.asarray(self._prev_phase)
            d["acc"] = np.asarray(self._acc_phase)
            d["tail"] = np.asarray(self._tail)
        return d

    def restore_blob(self, d: dict):
        import jax.numpy as jnp
        self._ha = int(d["ha"])
        self._buf = np.asarray(d["buf"], np.float32).reshape(-1, self.channels)
        self._primed = bool(d["primed"])
        if self._primed:
            self._prev_phase = jnp.asarray(d["prev"])
            self._acc_phase = jnp.asarray(d["acc"])
            self._tail = jnp.asarray(d["tail"])

    # ---------------------------------------------------------- process
    def _need(self) -> int:
        return (F_CHUNK - 1) * self._ha + N_FFT

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """Feed PCM, return whatever stretched PCM is ready (possibly
        empty). Output is chunking-invariant: only full F_CHUNK-frame
        chunks are processed, the residue waits."""
        pcm = np.asarray(pcm, np.float32).reshape(-1, self.channels)
        self._buf = pcm if not len(self._buf) else np.concatenate(
            [self._buf, pcm])
        return self._drain()

    def flush(self) -> np.ndarray:
        """End of stream: zero-pad so every frame whose start lies in
        the buffered residue is emitted, trim the chunk padding's
        surplus, then reset for reuse. Each drained chunk consumed
        F_CHUNK*ha input for F_CHUNK*HOP_SYN output, so the residue's
        ceil(len/ha) frames complete the duration contract (output ==
        input/speed to within one hop, per speed regime — accounting is
        pure integer sample counts, immune to drift on long streams)."""
        f_left = -(-len(self._buf) // self._ha)
        if f_left == 0:
            self.reset()
            return np.zeros((0, self.channels), np.float32)
        pad = (-(-f_left // F_CHUNK) * F_CHUNK - 1) * self._ha + N_FFT \
            - len(self._buf)
        if pad > 0:
            self._buf = np.concatenate(
                [self._buf, np.zeros((pad, self.channels), np.float32)])
        out = self._drain()[: f_left * HOP_SYN]
        self.reset()
        return out

    def _drain(self) -> np.ndarray:
        global _scan_jit
        import jax
        import jax.numpy as jnp
        pend = []  # (device emits [C, F*HS, ch], n_live) awaiting D2H
        while len(self._buf) >= self._need():
            if _scan_jit is None:
                _scan_jit = jax.jit(_chunk_scan)
            if not self._primed:
                B = N_FFT // 2 + 1
                self._prev_phase = jnp.zeros((B, self.channels), jnp.float32)
                self._acc_phase = jnp.zeros((B, self.channels), jnp.float32)
                self._tail = jnp.zeros((N_FFT - HOP_SYN, self.channels),
                                       jnp.float32)
            ha = self._ha
            k = 1  # chunks this dispatch: as many as the buffer holds
            while k < C_SCAN and len(self._buf) >= \
                    ((k + 1) * F_CHUNK - 1) * ha + N_FFT:
                k += 1
            stage = np.zeros((_CAP, self.channels), np.float32)
            n = min(_CAP, len(self._buf))
            stage[:n] = self._buf[:n]
            emits, self._prev_phase, self._acc_phase, self._tail = _scan_jit(
                jnp.asarray(stage), jnp.int32(ha), self._prev_phase,
                self._acc_phase, self._tail, jnp.bool_(self._primed),
                jnp.int32(k))
            self._primed = True
            try:  # overlap this dispatch's D2H with the next dispatch
                emits.copy_to_host_async()
            except Exception:
                pass
            pend.append((emits, k))
            self._buf = self._buf[k * F_CHUNK * ha:]
        if not pend:
            return np.zeros((0, self.channels), np.float32)
        outs = [np.asarray(e)[:k].reshape(k * F_CHUNK * HOP_SYN, -1)
                for e, k in pend]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)


def stretch(pcm: np.ndarray, speed: float) -> np.ndarray:
    """Offline convenience: stretch a whole [n, ch] (or [n]) buffer."""
    x = np.asarray(pcm, np.float32)
    mono = x.ndim == 1
    if mono:
        x = x[:, None]
    ts = TimeStretch(x.shape[1], speed)
    out = np.concatenate([ts.process(x), ts.flush()])
    return out[:, 0] if mono else out
