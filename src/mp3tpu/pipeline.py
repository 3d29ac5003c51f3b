"""File-level decode orchestration: host unpack -> device windows -> PCM.

Single-file decode runs as [S=1, G] windows with explicit state carry;
batched decode stacks streams on the S axis (SURVEY.md §3.1/§3.2).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .bitstream.unpack import SymbolTensors, unpack_fast
from .container import frames as fr
from .container.id3 import parse_id3v2
from .container.xing import StreamInfo, is_metadata_frame, parse_stream_info
from .kernels import pipeline as kp

# One canonical window shape for all single-stream paths: identical jit
# executables produce bit-identical PCM (XLA reduction order varies with
# shape, so shape consistency IS the determinism contract; SURVEY.md §7.5).
WINDOW = 32
# Windows per device dispatch: the single-stream decode program is ONE
# lax.scan over GROUP_WINDOWS windows (kp.decode_window_group). The scan's
# prefix property lets the player decode partial groups / pre-roll with
# the SAME executable, so play/seek/decode stay bit-identical while long
# decodes cost 1 dispatch per 8 windows instead of 8.
GROUP_WINDOWS = 8


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


_quantize_group_jit = None


def _iter_group_pcm(st: SymbolTensors, window: int, group: int):
    """Yield (pcm_device [1, window*group*576, 2] f32, n_valid_granules)
    per group of `group` windows, threading the scan state through —
    the ONE group loop every single-stream grouped path (PCM decode,
    envelope/loudness scans) shares, so the partial-group zero-padding
    and the shared-program bit-exactness contract (CLAUDE.md) live in
    one place. The scan's prefix property makes the real granules' PCM
    independent of the padding."""
    from .utils.profiling import annotate
    G = st.n_granules
    state = kp.init_state(1)
    span = window * group
    for start in range(0, G, span):
        g = min(span, G - start)
        sl = slice(start, start + g)

        def prep(a):
            a = a[sl]
            if g != span:  # zero-pad the final partial group
                width = ((0, span - g),) + tuple((0, 0) for _ in a.shape[1:])
                a = np.pad(a, width)
            return jnp.asarray(a[None])  # add S axis

        with annotate(f"mp3tpu.decode_group[{start}:{start + g}]"):
            pcm, state = kp.decode_window_group(
                prep(st.is_), prep(st.exp), prep(st.block_type),
                prep(st.mixed), prep(st.smode), state, st.sample_rate, group)
        yield pcm, g


def decode_symbols_device(st: SymbolTensors,
                          window: int = WINDOW,
                          group: int = GROUP_WINDOWS,
                          output: str = "float32") -> np.ndarray:
    """Run the device pipeline over all granules of one stream.

    Decodes in groups of `group` windows — ONE dispatch per group via
    the shared single-stream scan program (kp.decode_window_group).

    output="int16" quantizes each group ON DEVICE (a separate jitted
    elementwise program on the scan's float output, so the decode
    executable — and its numerics — are untouched) and downloads the 4x
    smaller int16; elementwise quantize commutes with concatenation and
    slicing, so the result is bit-identical to quantizing the assembled
    float PCM. Returns PCM [n, channels] in the requested dtype.
    """
    import jax
    global _quantize_group_jit
    i16 = output == "int16"
    if i16 and _quantize_group_jit is None:
        _quantize_group_jit = jax.jit(kp.quantize_i16)
    out = []
    for pcm, g in _iter_group_pcm(st, window, group):
        dev = _quantize_group_jit(pcm) if i16 else pcm
        out.append(np.asarray(dev)[0, : g * 576])
    pcm = np.concatenate(out, axis=0)
    return pcm[:, : st.channels]


_env_group_jit: dict = {}
ENV_HOP = 576  # envelope hop = one granule (13 ms @ 44.1 kHz)


def decode_envelope_device(st: SymbolTensors, window: int = WINDOW,
                           group: int = GROUP_WINDOWS,
                           with_peak: bool = False,
                           peak_bounds: tuple | None = None):
    """Per-granule power envelope (dB) of one stream, computed ON
    DEVICE group by group: the PCM never leaves the device — only
    ~1 KB of envelope crosses D2H per 147k-sample group, so indexing a
    library for silence/sentences this way runs at device decode speed
    instead of download speed. Returns env_db [n_granules] float32;
    frame f covers samples [f*ENV_HOP, (f+1)*ENV_HOP).

    with_peak=True also reduces the stream's sample peak (max |x|,
    linear) inside the same dispatches and returns (env_db, peak) —
    the loudness scan needs it for clipping-safe normalization.
    peak_bounds=(lo, hi) restricts the peak reduction to that sample
    range (the gapless-trimmed PLAYABLE window, so the clipping clamp
    uses the peak the listener can actually hear); the envelope always
    covers the full decoded timeline. Bounds are traced scalars — one
    executable serves every bound."""
    import jax
    key = (st.channels, with_peak)
    fn = _env_group_jit.get(key)
    if fn is None:
        nch = st.channels

        def env_of(pcm, start, lo, hi):
            # [1, span*576, 2] float -> [span] dB (+ bounded peak)
            x = pcm[0, :, :nch]
            p = jnp.mean(x * x, axis=1)
            e = jnp.mean(p.reshape(-1, ENV_HOP), axis=1)
            env = 10.0 * jnp.log10(e + 1e-12)
            if with_peak:
                idx = start + jnp.arange(x.shape[0])
                m = ((idx >= lo) & (idx < hi)).astype(jnp.float32)
                return env, jnp.max(jnp.abs(x) * m[:, None])
            return env

        fn = jax.jit(env_of)
        _env_group_jit[key] = fn
    lo, hi = peak_bounds if peak_bounds is not None else (0, st.n_granules * 576)
    out, peak, pos = [], 0.0, 0
    for pcm, g in _iter_group_pcm(st, window, group):
        r = fn(pcm, jnp.int32(pos), jnp.int32(lo), jnp.int32(hi))
        pos += g * 576
        if with_peak:
            out.append(np.asarray(r[0])[:g])
            peak = max(peak, float(r[1]))
        else:
            out.append(np.asarray(r)[:g])
    env = np.concatenate(out)
    return (env, peak) if with_peak else env


_env_batch_jit = None


def _env_batch(pcm, nch, bounds):
    """Batched per-granule dB envelope + per-stream sample peak of
    int16 PCM [S, n, 2]; `nch` [S, 1] masks the unused channel of mono
    streams (their power is the real channel's, whatever the decode
    left in channel 1). The peak is reduced over `bounds` [S, 2] int32
    sample ranges [lo, hi) — the gapless-trimmed PLAYABLE window, so
    clipping-safe normalization caps against the peak the listener can
    hear, not the encoder padding's ring-out (VERDICT r3 weak #6).
    The envelope covers the full timeline. Returns (env_db [S, G],
    peak [S] linear)."""
    x = pcm.astype(jnp.float32) * (1.0 / 32768.0)
    m1 = (nch >= 2.0).astype(jnp.float32)
    p = (x[..., 0] ** 2 + x[..., 1] ** 2 * m1) / nch       # [S, n]
    e = p.reshape(p.shape[0], -1, ENV_HOP).mean(axis=2)    # [S, G]
    idx = jnp.arange(x.shape[1])[None, :]
    m = ((idx >= bounds[:, :1]) & (idx < bounds[:, 1:2])).astype(jnp.float32)
    pk = jnp.maximum(jnp.max(jnp.abs(x[..., 0]) * m, axis=1),
                     jnp.max(jnp.abs(x[..., 1]) * m * m1, axis=1))
    return 10.0 * jnp.log10(e + 1e-12), pk


def _shift_segments(segs, total, sr, info, gapless):
    """Sample segments on the untrimmed timeline -> seconds on the
    gapless-trimmed one (the clock decode()/play use)."""
    a, b = 0, total
    if gapless and info.gapless:
        from .dsp.gapless import gapless_bounds
        a, b = gapless_bounds(total, info.encoder_delay,
                              info.encoder_padding)
    out = []
    for s, e in segs:
        s2, e2 = max(s - a, 0), min(e - a, b - a)
        if e2 > s2:
            out.append((s2 / sr, e2 / sr))
    return out


from dataclasses import dataclass


@dataclass
class _DecodedStream:
    """One stream of a DecodedBatch: a row of a shared device chunk
    ([S, n_pad, 2] int16 in HBM), or host PCM for fallback streams."""
    dev: object              # jax int16 chunk array, or None (host rec)
    row: int
    host: object             # np int16 [n, nch] when dev is None
    n: int                   # decoded samples on the stored timeline
    skip: int                # decode-time gapless bounds (numpy() view)
    end: int
    t_lo: int                # playable (LAME-tag) bounds: peak masking
    t_hi: int
    nch: int
    rate: int
    info: object             # StreamInfo for timeline shifting


class DecodedBatch:
    """Device-resident batched decode result (SURVEY.md §3.2/L5,
    BASELINE config 3): what decode_batch(..., output="device")
    returns. Each chunk of streams decodes into ONE int16 [S, n, 2]
    array that STAYS in HBM, so serving-style consumers chain further
    device stages — the built-in loudness/segment scans below, or
    custom jax code via device_pcm() — without a D2H transfer in the
    loop. .numpy() materializes host PCM identical to
    output="pcm" (it is the same executable and the same trims).

    Streams that fall back to the host path (native unpacker absent,
    chunk over the staging budget) carry host PCM; every method
    behaves identically for them.
    """

    def __init__(self, recs):
        self._recs = recs

    def __len__(self):
        return len(self._recs)

    @property
    def sample_rates(self):
        return [r.rate for r in self._recs]

    def device_pcm(self, i):
        """(chunk_array, row, lo, hi, nch) for stream i: its PCM is
        chunk[row, lo:hi, :nch] with the decode-time gapless bounds
        applied. Returned unsliced so device consumers can gather at
        fixed shapes (a per-stream slice would compile one executable
        per (offset, length)). Host-fallback streams return their
        numpy array with row 0."""
        r = self._recs[i]
        if r.dev is not None:
            return r.dev, r.row, r.skip, r.end, r.nch
        return r.host[None], 0, r.skip, r.end, r.nch

    def numpy(self, i=None):
        """Materialize host PCM: (pcm, sample_rate) for stream i, or
        the full list — element-for-element what output="pcm" returns.
        Each device chunk downloads once (np.asarray caches per
        Array), so iterating streams does not re-transfer."""
        if i is None:
            return [self.numpy(j) for j in range(len(self._recs))]
        r = self._recs[i]
        if r.dev is None:
            # copy like the device branch below: callers own the result
            # and must not be able to mutate the handle's stored PCM
            return r.host[r.skip:r.end, : r.nch].copy(), r.rate
        pcm = np.asarray(r.dev)
        return pcm[r.row, r.skip:r.end, : r.nch].copy(), r.rate

    def _envelope(self, i, cache):
        """(env_db [G] over the stored timeline, playable peak linear)
        for stream i; device chunks reduce in ONE batched dispatch
        (cached per chunk), host recs use the identical formula."""
        r = self._recs[i]
        if r.dev is None:
            x = r.host[:, : r.nch].astype(np.float32) / 32768.0
            p = (x ** 2).mean(axis=1)
            Gn = len(p) // ENV_HOP
            e = p[: Gn * ENV_HOP].reshape(Gn, ENV_HOP).mean(axis=1)
            env = (10.0 * np.log10(e + 1e-12)).astype(np.float32)
            seg = x[r.t_lo: r.t_hi]
            pk = float(np.abs(seg).max()) if seg.size else 0.0
            return env, pk
        key = id(r.dev)
        if key not in cache:
            global _env_batch_jit
            if _env_batch_jit is None:
                import jax
                _env_batch_jit = jax.jit(_env_batch)
            S = r.dev.shape[0]
            nch = np.full((S, 1), 2.0, np.float32)
            bounds = np.zeros((S, 2), np.int32)
            for rr in self._recs:
                if rr.dev is r.dev:
                    nch[rr.row, 0] = float(rr.nch)
                    bounds[rr.row] = (rr.t_lo, rr.t_hi)
            env, pk = _env_batch_jit(r.dev, jnp.asarray(nch),
                                     jnp.asarray(bounds))
            cache[key] = (np.asarray(env), np.asarray(pk))
        env, pk = cache[key]
        return env[r.row], float(pk[r.row])

    def levels(self):
        """(loudness_db, peak_db) per stream from one batched envelope
        reduction per device chunk — PCM never crosses D2H. The peak
        is the PLAYABLE (gapless-trimmed) peak, so clipping-safe
        normalization caps against what the listener can actually hear
        (VERDICT r4 task 7)."""
        from .dsp.loudness import loudness_db
        cache: dict = {}
        out = []
        for i, r in enumerate(self._recs):
            env, pk = self._envelope(i, cache)
            G = min(r.n // ENV_HOP, len(env))
            out.append((loudness_db(_playable_env(env[:G], r.t_lo, r.t_hi),
                                    ENV_HOP, r.rate),
                        20.0 * float(np.log10(max(pk, 1e-9)))))
        return out

    def segments(self, gapless: bool | None = None, **kw):
        """Sentence/pause boundaries per stream (dsp/segment semantics
        at the fused ENV_HOP granule hop) — segment_batch's output,
        computed from this handle's device-resident PCM."""
        from .config import get_active
        from .dsp.segment import segments_from_envelope
        if gapless is None:
            gapless = get_active().decode.gapless
        cache: dict = {}
        out = []
        for i, r in enumerate(self._recs):
            kw2 = _check_seg_kw(kw, r.rate)
            env, _pk = self._envelope(i, cache)
            G = min(r.n // ENV_HOP, len(env))
            segs = segments_from_envelope(env[:G], ENV_HOP, r.rate,
                                          total=r.n, **kw2)
            out.append(_shift_segments(segs, r.n, r.rate, r.info, gapless))
        return out


def _host_rec(pcm, rate, info, gapless: bool) -> _DecodedStream:
    """Host-fallback DecodedBatch record. When the stored PCM is
    already gapless-trimmed, the playable window is the whole buffer
    and timeline shifting is disabled (info replaced by a tagless
    StreamInfo so segments() does not trim twice)."""
    n = len(pcm)
    if gapless and info.gapless:
        return _DecodedStream(dev=None, row=0, host=pcm, n=n, skip=0,
                              end=n, t_lo=0, t_hi=n, nch=pcm.shape[1],
                              rate=rate, info=StreamInfo())
    if info.gapless:
        from .dsp.gapless import gapless_bounds
        t_lo, t_hi = gapless_bounds(n, info.encoder_delay,
                                    info.encoder_padding)
        t_hi = min(t_hi, n)
    else:
        t_lo, t_hi = 0, n
    return _DecodedStream(dev=None, row=0, host=pcm, n=n, skip=0, end=n,
                          t_lo=t_lo, t_hi=t_hi, nch=pcm.shape[1],
                          rate=rate, info=info)


def segment_file(path_or_bytes, gapless: bool | None = None, **kw):
    """Sentence/pause boundaries [(start_s, end_s), ...] of one file
    (dsp/segment.py semantics) WITHOUT downloading its PCM — the
    envelope reduction runs inside the decode dispatches. Boundaries
    are on the gapless-trimmed timeline (the same clock decode()/play
    use) when the LAME tag is present.

    The envelope hop is fixed at one granule (ENV_HOP=576, ~13 ms):
    unlike Player.segments(), `hop_s` is not tunable here — the
    reduction is fused into the decode dispatch at granule resolution.
    A hop_s that rounds to a different hop is rejected rather than
    silently ignored."""
    from .config import get_active
    from .dsp.segment import segments_from_envelope
    if gapless is None:
        gapless = get_active().decode.gapless
    data = _read(path_or_bytes)
    st, info, _index = load_symbols(data)
    kw = _check_seg_kw(kw, st.sample_rate)
    env = decode_envelope_device(st)
    total = st.n_granules * 576
    segs = segments_from_envelope(env, ENV_HOP, st.sample_rate,
                                  total=total, **kw)
    return _shift_segments(segs, total, st.sample_rate, info, gapless)


def _check_seg_kw(kw: dict, sr: int) -> dict:
    """Device-envelope segmentation runs at the fixed ENV_HOP granule
    hop; accept hop_s only when it IS that hop for THIS sample rate,
    else fail loudly instead of passing an unknown kwarg downstream.
    Returns a new dict without hop_s — the input is never mutated, so
    batched callers can validate the same kwargs against every chunk's
    rate (acceptance must not depend on chunk order)."""
    kw = dict(kw)
    hop_s = kw.pop("hop_s", None)
    if hop_s is not None and int(round(hop_s * sr)) != ENV_HOP:
        raise ValueError(
            f"device-envelope segmentation has a fixed {ENV_HOP}-sample "
            f"({ENV_HOP / sr:.4f} s at {sr} Hz) hop; hop_s={hop_s} is only "
            "available through Player.segments() (host envelope)")
    return kw


def loudness_file(path_or_bytes) -> float:
    """Track loudness in dB (ReplayGain-style 95th-percentile block
    statistic, dsp/loudness.py) from the device-computed envelope —
    the scan a normalizing queue runs per track; PCM never downloads."""
    return track_levels(path_or_bytes)[0]


def track_levels(path_or_bytes) -> tuple:
    """(loudness_db, peak_db) of one track from a single device
    envelope scan — loudness drives normalization toward the target,
    the sample peak caps the boost so normalization never clips
    (dsp/loudness.py normalization_gain_db).

    The peak is reduced over the PLAYABLE window — the gapless-trimmed
    range when a LAME tag is present — inside the same device
    dispatches, so the clipping clamp uses the peak the listener can
    actually hear, not the encoder delay/padding region's content
    (VERDICT r4 task 7). The loudness envelope covers the full decoded
    timeline (silent edges are gated out of the statistic)."""
    from .dsp.loudness import loudness_db
    st, info, _index = load_symbols(_read(path_or_bytes))
    n = st.n_granules * 576
    if info.gapless:
        from .dsp.gapless import gapless_bounds
        lo, hi = gapless_bounds(n, info.encoder_delay, info.encoder_padding)
        hi = min(hi, n)
    else:
        lo, hi = 0, n
    env, peak = decode_envelope_device(st, with_peak=True,
                                       peak_bounds=(lo, hi))
    pk_db = 20.0 * float(np.log10(max(peak, 1e-9)))
    return loudness_db(_playable_env(env, lo, hi), ENV_HOP,
                       st.sample_rate), pk_db


def _playable_env(env, lo: int, hi: int):
    """Envelope frames fully inside the playable sample range [lo, hi)
    — the loudness statistic, like the peak, describes what the
    listener hears, not the trimmed delay/padding content."""
    f_lo, f_hi = -(-lo // ENV_HOP), hi // ENV_HOP
    return env[f_lo:f_hi] if f_hi > f_lo else env


def track_levels_batch(paths) -> list:
    """track_levels over many files through the public device-resident
    batch handle (SURVEY.md §3.2): one packed-plane scan dispatch per
    chunk + one batched envelope reduction — [S] loudness/peak values
    download instead of PCM, so library-wide loudness indexing runs at
    aggregate device decode speed. Peaks here are measured on the
    quantized int16 PCM (<=1 LSB below the single-stream float
    measurement) over each stream's playable window."""
    datas = [_read(p) for p in paths]
    res = _decode_files_fast(datas, gapless=False, output="device",
                             slow_streams="skip")
    if res is None:  # no native unpacker / general-path corner
        return [track_levels(d) for d in datas]
    # over-budget (very long) streams skip the batch handle and ride the
    # per-file device-envelope path — KBs of D2H instead of the full PCM
    # download the handle's host-fallback records would pay
    idx = [i for i, r in enumerate(res) if r is not None]
    vals = DecodedBatch([res[i] for i in idx]).levels()
    out: list = [None] * len(datas)
    for i, v in zip(idx, vals):
        out[i] = v
    for i, r in enumerate(res):
        if r is None:
            out[i] = track_levels(datas[i])
    return out


def segment_files(paths, gapless: bool | None = None, **kw):
    """segment_file over many files (library indexing) through the
    public device-resident batch handle — C++ window-major unpack, one
    packed-plane scan dispatch per chunk, envelope reduction on the
    in-HBM PCM — so a large library indexes at aggregate device decode
    speed, not at the speed of downloading its PCM."""
    from .config import get_active
    if gapless is None:
        gapless = get_active().decode.gapless
    datas = [_read(p) for p in paths]
    res = _decode_files_fast(datas, gapless=False, output="device",
                             slow_streams="skip")
    if res is None:  # no native unpacker / general-path corner
        return [segment_file(d, gapless=gapless, **kw) for d in datas]
    # over-budget streams take the per-file envelope path (see
    # track_levels_batch) — segmentation never needs their PCM on host
    idx = [i for i, r in enumerate(res) if r is not None]
    vals = DecodedBatch([res[i] for i in idx]).segments(gapless=gapless,
                                                        **kw)
    out: list = [None] * len(datas)
    for i, v in zip(idx, vals):
        out[i] = v
    for i, r in enumerate(res):
        if r is None:
            out[i] = segment_file(datas[i], gapless=gapless, **kw)
    return out


def split_file(path_or_bytes, out_dir, fmt: str = "wav",
               stem: str | None = None, bitrate: int | None = None,
               gapless: bool | None = None, **seg_kw) -> list:
    """Export each sentence/pause-delimited segment of one track as its
    own audio file — the reference's "study one sentence at a time"
    usage (reference README.md:46) materialized as clip files.

    Boundaries come from the device-envelope segmentation (PCM stays in
    HBM during the scan); the track is then decoded ONCE and sliced.
    fmt="wav" writes int16 WAV clips; fmt="mp3" re-encodes every clip
    in ONE encode_batch call (the batched device encoder — clips share
    the lockstep rate-loop rows, SURVEY.md §3.4). Returns the written
    paths in segment order."""
    import os
    from .config import get_active
    from .dsp.segment import segments_from_envelope
    if fmt not in ("wav", "mp3"):
        raise ValueError(f"fmt must be 'wav' or 'mp3', got {fmt!r}")
    cfg = get_active().decode
    if gapless is None:
        gapless = cfg.gapless
    data = _read(path_or_bytes)
    # ONE host unpack feeds both device passes (docs/host_unpack_notes
    # .md); boundaries are identical to segment_file's by construction
    st, info, _index = load_symbols(data)
    sr = st.sample_rate
    kw = _check_seg_kw(seg_kw, sr)
    total = st.n_granules * 576
    segs = _shift_segments(
        segments_from_envelope(decode_envelope_device(st), ENV_HOP, sr,
                               total=total, **kw),
        total, sr, info, gapless)
    if not segs:
        return []
    pcm = decode_symbols_device(st, window=cfg.window_granules,
                                output="int16")
    if gapless and info.gapless:
        from .dsp.gapless import gapless_bounds
        a, b = gapless_bounds(len(pcm), info.encoder_delay,
                              info.encoder_padding)
        pcm = pcm[a:b]
    if stem is None:
        stem = ("clip" if isinstance(path_or_bytes, (bytes, bytearray))
                else os.path.splitext(os.path.basename(
                    str(path_or_bytes)))[0])
    os.makedirs(out_dir, exist_ok=True)
    clips = [pcm[int(round(a * sr)): int(round(b * sr))] for a, b in segs]
    paths = [os.path.join(out_dir, f"{stem}-{i + 1:03d}.{fmt}")
             for i in range(len(clips))]
    if fmt == "mp3":
        from .encoder import encode_batch
        kw = {} if bitrate is None else {"bitrate": bitrate}
        blobs = encode_batch([c.astype(np.float32) / 32768.0
                              for c in clips], sr, **kw)
        for p, blob in zip(paths, blobs):
            with open(p, "wb") as f:
                f.write(blob)
    else:
        from .player.sink import WavFileSink
        for p, c in zip(paths, clips):
            snk = WavFileSink(p, sr, c.shape[1])
            snk.push(c)
            snk.close()
    return paths


def load_symbols(data: bytes):
    """Container parse + unpack: (SymbolTensors, StreamInfo, FrameIndex).

    Skips ID3v2 regions and a leading Xing/Info/VBRI metadata frame
    (which carries no audio)."""
    from .metrics import record_resyncs, record_symbol_errors
    id3 = parse_id3v2(data)
    buf = np.frombuffer(data, np.uint8)
    index = fr.scan_frames(buf, start=id3.size)
    info = parse_stream_info(data, int(index.offsets[0]), index.headers[0])
    st = unpack_fast(data)
    if is_metadata_frame(info):
        n = index.headers[0].n_granules
        st = SymbolTensors(
            is_=st.is_[n:], exp=st.exp[n:], block_type=st.block_type[n:],
            mixed=st.mixed[n:], smode=st.smode[n:], errors=st.errors[n:],
            huff_slack=st.huff_slack[n:], lines_used=st.lines_used[n:],
            sample_rate=st.sample_rate, channels=st.channels,
            version=st.version)
        index = fr.FrameIndex(
            offsets=index.offsets[1:], headers=index.headers[1:],
            junk_bytes=index.junk_bytes, sample_rate=index.sample_rate,
            channels=index.channels, version=index.version,
            resyncs=index.resyncs)
    # count AFTER the metadata-frame trim so the single-file books agree
    # with the batch fast path (which strips the Xing/Info frame's bytes
    # before unpacking — same audio frames, same counters)
    record_resyncs(index.resyncs)
    record_symbol_errors(st.errors, st.granules_per_frame)
    return st, info, index


def load_source(data: bytes):
    """Container parse + STREAMING symbol source: (SymbolSource,
    StreamInfo, FrameIndex). Unlike load_symbols, no audio is unpacked
    up front — the player's refill loop pulls granule windows on demand
    (first-audio latency and host memory O(window); SURVEY.md §3.3)."""
    from .bitstream.source import SymbolSource
    id3 = parse_id3v2(data)
    body = data[id3.size:] if id3.size else data
    buf = np.frombuffer(body, np.uint8)
    index = fr.scan_frames(buf)
    info = parse_stream_info(body, int(index.offsets[0]), index.headers[0])
    skip = 1 if is_metadata_frame(info) else 0
    src = SymbolSource(body, index=index, skip_frames=skip)
    if skip:
        index = fr.FrameIndex(
            offsets=index.offsets[1:], headers=index.headers[1:],
            junk_bytes=index.junk_bytes, sample_rate=index.sample_rate,
            channels=index.channels, version=index.version,
            resyncs=index.resyncs)
    return src, info, index


def decode_file(path_or_bytes, output: str | None = None,
                gapless: bool | None = None):
    """decode(path) -> (pcm, sample_rate) [SURVEY.md §3.1].

    output: "int16" (default, spec-rounded) or "float32".
    gapless: trim encoder delay/padding per the LAME tag when present,
    so decode(encode(x)) is sample-aligned with x.
    Unset parameters fall back to the active Config (mp3tpu.init —
    SURVEY.md §5.6); device windows run under §5.1 trace annotations
    (MP3TPU_TRACE_DIR wraps them in a jax.profiler trace).
    """
    from .config import get_active
    from .utils.profiling import device_trace
    cfg = get_active().decode
    output = cfg.output if output is None else output
    gapless = cfg.gapless if gapless is None else gapless
    data = _read(path_or_bytes)
    st, info, _index = load_symbols(data)
    with device_trace():
        # int16 quantizes on device per group: only int16 crosses D2H,
        # nothing is re-uploaded (quantize commutes with the trim below)
        pcm = decode_symbols_device(st, window=cfg.window_granules,
                                    output=output)
    if gapless and info.gapless:
        from .dsp.gapless import gapless_bounds
        a, b = gapless_bounds(len(pcm), info.encoder_delay, info.encoder_padding)
        pcm = pcm[a:b]
    return pcm, st.sample_rate


def decode_files(paths, gapless: bool = True, output: str = "pcm"):
    """Batched multi-stream decode. output="pcm" (default) returns a
    list of (pcm, sample_rate) aligned with the inputs, applying the
    same LAME gapless trim as decode_file so batch and single paths
    agree on output lengths.

    output="device" returns a DecodedBatch handle instead: the decoded
    int16 PCM STAYS in HBM (one chunk array per fixed-shape batch
    step), so serving-style consumers chain device stages — levels(),
    segments(), custom jax code via device_pcm() — without a D2H
    transfer in the loop, and materialize with .numpy() only when host
    PCM is actually needed (SURVEY.md §3.2/L5; the structure bench.py's
    headline measures, reachable through the public API).

    Uses the bench-grade fast path when the native unpacker is present
    (packed spectrum/exponent planes written window-major by C++, fixed-
    shape per-window device steps); falls back to the masked-batch
    scheduler otherwise (pure-Python unpack, mixed corner cases) — a
    "device" handle then carries host-resident records that behave
    identically.

    slow_streams: what to do with over-budget chunks (streams too long
    for the staging budget). "decode" (default) runs them through the
    scheduler path; "skip" leaves their result slots None so envelope-
    only consumers (track_levels_batch/segment_files) can route them
    through the per-file device-envelope path instead of paying a full
    PCM download they would immediately reduce away."""
    if output not in ("pcm", "device"):
        raise ValueError(f'output must be "pcm" or "device", got {output!r}')
    datas = []
    for p in paths:
        if isinstance(p, (bytes, bytearray)):
            datas.append(bytes(p))
        else:
            with open(p, "rb") as f:
                datas.append(f.read())
    fast = _decode_files_fast(datas, gapless, output=output)
    if fast is not None:
        return DecodedBatch(fast) if output == "device" else fast
    from .player.scheduler import decode_batch_streams
    if output != "device":
        return decode_batch_streams(datas, gapless=gapless)
    res, infos = decode_batch_streams(datas, gapless=gapless,
                                      return_info=True)
    return DecodedBatch([
        _host_rec(pcm, rate, info, gapless)
        for info, (pcm, rate) in zip(infos, res)])


def _decode_files_fast(datas, gapless: bool, output: str = "pcm",
                       slow_streams: str = "decode"):
    """Throughput path for decode_files (SURVEY.md §3.2, the structure
    bench.py measures): C++ unpacks every stream's granules directly
    into window-major packed batch tensors (4-bit spectrum plane +
    two-level escape sideband + byte exponents, with the widening
    fallback chain), each [S, win] window stages as one small async
    device_put and decodes with the fixed-shape
    packed jit. Chunk size, device window and initial plane width come
    from the active Config (SURVEY.md §5.6). Streams are length-sorted
    before chunking so one long file cannot inflate a whole chunk's
    padding; chunks whose staging buffers would exceed batch_max_mb
    stream through the scheduler path instead (masked elastic batch).
    Returns None when any input needs the general path."""
    from .bitstream import native as nat
    import ctypes
    import jax.numpy as jnp
    from .config import get_active
    cfg = get_active().decode
    if not cfg.use_native or not nat.available():
        return None
    lib = nat._load()
    try:
        metas = []
        for d in datas:
            id3 = parse_id3v2(d)
            body = d[id3.size:] if id3.size else d
            buf = np.frombuffer(body, np.uint8)
            index = fr.scan_frames(buf)
            info = parse_stream_info(body, int(index.offsets[0]),
                                     index.headers[0])
            if is_metadata_frame(info):
                if len(index.offsets) < 2:
                    return None
                off = int(index.offsets[1])
                h = index.headers[1]
                # dropping the metadata frame's bytes is only exact when
                # the first audio frame's reservoir pointer is 0 (every
                # mainstream encoder; verify and fall back otherwise)
                si = off + 4 + (2 if h.crc_protected else 0)
                if si + 2 > len(body):
                    return None
                mdb = (body[si] << 1) | (body[si + 1] >> 7)
                if mdb != 0:
                    return None
                body = body[off:]
            metas.append((body, info, index.sample_rate, index.channels,
                          index.version, index.resyncs))
    except Exception:
        return None

    # probe granule counts up front (cheap) for length-sorted chunking
    meta4 = (ctypes.c_int32 * 4)()
    G_all = []
    for m in metas:
        g = lib.mp3tpu_probe(m[0], len(m[0]), meta4)
        if g <= 0:
            return None
        G_all.append(g)

    out: list = [None] * len(datas)
    slow: list = []
    pending_faults: list = []
    rates = sorted({m[2] for m in metas})
    for rate in rates:
        idxs = sorted((i for i, m in enumerate(metas) if m[2] == rate),
                      key=lambda i: G_all[i])
        for c0 in range(0, len(idxs), cfg.batch_chunk_streams):
            chunk = idxs[c0: c0 + cfg.batch_chunk_streams]
            win = cfg.window_granules
            n_win = -(-max(G_all[i] for i in chunk) // win)
            nb = 1 << max(0, n_win - 1).bit_length()  # device bucket
            # _fast_chunk allocates FULL batch_chunk_streams-wide buffers
            # regardless of chunk occupancy (fixed jit shapes), so the
            # estimate must use S, not len(chunk): ~934 staged host bytes
            # per granule at the 4-bit plane plus the bucketed int16
            # device PCM output ([S, nb*win*576, 2])
            S = cfg.batch_chunk_streams
            est_mb = S * (n_win * win * 934 + nb * win * 2304) / 1e6
            if est_mb > cfg.batch_max_mb:
                slow.extend(chunk)
                continue
            if not _fast_chunk(datas, metas, chunk,
                               [G_all[i] for i in chunk], rate, gapless,
                               out, lib, jnp, cfg, output, pending_faults):
                return None
    # fault accounting commits only once the WHOLE fast path succeeded:
    # a later chunk's `return None` sends every stream to the fallback,
    # which keeps its own books — recording per-chunk would double-count
    # the chunks that had already landed
    from .metrics import record_resyncs, record_symbol_errors
    for errs, ngr, nrs in pending_faults:
        record_symbol_errors(errs, ngr)
        record_resyncs(nrs)
    if slow and slow_streams == "skip":
        slow = []
    if slow:
        from .player.scheduler import decode_batch_streams
        res = decode_batch_streams([datas[i] for i in slow],
                                   gapless=gapless)
        if output == "device":
            # over-budget chunks fall back to host records (the handle
            # promises PCM access; these rare very-long streams pay the
            # download the fast chunks avoid)
            for i, (pcm, rrate) in zip(slow, res):
                out[i] = _host_rec(pcm, rrate, metas[i][1], gapless)
        else:
            for i, r in zip(slow, res):
                out[i] = r
    return out


def _fast_chunk(datas, metas, chunk, Gs, rate, gapless, out, lib, jnp, cfg,
                output: str = "pcm", pending_faults: list | None = None):
    from .bitstream.native import unpack_native_into12
    S = cfg.batch_chunk_streams
    win = cfg.window_granules
    n_win = -(-max(Gs) // win)
    Gpad = n_win * win

    plane_bits, exp_bytes = cfg.plane_bits, True
    while True:
        shp = {4: 288, 8: 576, 12: 864}[plane_bits]
        dt = {4: np.uint8, 8: np.int8, 12: np.uint8}[plane_bits]
        esc_shape = {4: (80,), 8: (16, 2), 12: (16, 2)}[plane_bits]
        esc_dt = np.int8 if plane_bits == 4 else np.int16
        b = {
            "is12": np.zeros((n_win, S, win, 2, shp), dt),
            "esc": np.zeros((n_win, S, win, 2) + esc_shape, esc_dt),
            "exp": (np.zeros((n_win, S, win, 2, 65), np.uint8) if exp_bytes
                    else np.zeros((n_win, S, win, 2, 64), np.int16)),
            "bt": np.zeros((n_win, S, win, 2), np.int8),
            "mx": np.zeros((n_win, S, win, 2), np.uint8),
            "smode": np.zeros((n_win, S, win, 64), np.uint8),
        }
        import os
        from concurrent.futures import ThreadPoolExecutor

        errs: dict = {}

        def _one(args):
            k, i = args
            e = np.zeros(Gs[k], np.int16)
            r = unpack_native_into12(
                metas[i][0], Gs[k], None, b["exp"], b["bt"], b["mx"],
                b["smode"], b["is12"], b["esc"], k, S, win,
                plane_bits=plane_bits | (0x10 if exp_bytes else 0), err=e)
            if r:
                errs[k] = e
            return r

        # streams are independent and the C ABI releases the GIL: pool
        # across cores (SURVEY.md P4 host worker pool; sequential on a
        # 1-core host)
        workers = min(8, os.cpu_count() or 1)
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                ok = all(ex.map(_one, enumerate(chunk)))
        else:
            ok = all(map(_one, enumerate(chunk)))
        if ok:
            break
        if exp_bytes:
            exp_bytes = False
        elif plane_bits == 4:
            plane_bits = 8
        elif plane_bits == 8:
            plane_bits = 12
        else:
            return False

    # fault accounting for the streams riding THIS fast path, DEFERRED:
    # the caller commits these only when every chunk succeeds (a later
    # chunk's abort reruns everything through the fallback, which keeps
    # its own books)
    if pending_faults is not None:
        for k, i in enumerate(chunk):
            ngr = 2 if metas[i][4] == fr.VERSION_MPEG1 else 1
            pending_faults.append((errs[k], ngr, metas[i][5]))

    from .kernels import pipeline as kp
    state = kp.init_state(S)
    # bucket the window count (powers of two) so the one-dispatch scan
    # compiles for a handful of lengths; pad windows are zeros (silence)
    nb = 1
    while nb < n_win:
        nb *= 2
    import jax
    keys = ("is12", "esc", "exp", "bt", "mx", "smode")
    arena_mode = plane_bits == 4 and exp_bytes
    if arena_mode:
        # arena staging: each live window ships as ONE contiguous uint8
        # put (~S*win*934 B, <=2 MB at the default shapes), split back
        # into the six plane tensors INSIDE the jitted scan; one zero
        # arena serves every pad window. 6x fewer transfers than
        # per-plane staging, same program economics (keyed on the nb
        # bucket), bit-identical output (tests/test_device_batch.py).
        wb, layout = kp.window_arena_layout(S, win)

        def _win_arena(w):
            buf = np.empty(wb, np.uint8)
            for k, off, shp, dt in layout:
                n = int(np.prod(shp))
                buf[off:off + n] = b[k][w].ravel().view(np.uint8)
            return buf
        zero_arena = jax.device_put(np.zeros(wb, np.uint8))
        win_arenas = [jax.device_put(_win_arena(w)) if w < n_win
                      else zero_arena for w in range(nb)]

        def _scan(lo, per, st):
            return kp.decode_window_arenas_i16(
                win_arenas[lo: lo + per], st, rate, S, win)
    else:
        # widened-plane fallback (int16 escapes/exponents): per-window
        # standalone buffers, each its own <=1.5 MB async put
        win_dev = {k: [] for k in keys}
        zeros = {k: jnp.asarray(np.zeros_like(b[k][0])) for k in keys}
        for w in range(nb):
            for k in keys:
                win_dev[k].append(jnp.asarray(np.ascontiguousarray(b[k][w]))
                                  if w < n_win else zeros[k])

        def _scan(lo, per, st):
            args = [win_dev[k][lo: lo + per] for k in keys]
            return kp.decode_windows_scan_i16(*args, st, rate,
                                              plane_bits=plane_bits)
    if output == "device":
        # public serving path (SURVEY.md §3.2, BASELINE config 3): ONE
        # scan dispatch; the int16 PCM stays in HBM — only the bucket
        # padding is sliced off on device. Consumers (DecodedBatch)
        # chain device reductions or materialize later.
        pcm_dev, _st = _scan(0, nb, state)
        dev = pcm_dev[:, : n_win * win * 576]
        from .dsp.gapless import gapless_bounds
        for k, i in enumerate(chunk):
            info = metas[i][1]
            n = Gs[k] * 576
            if info.gapless:
                t_lo, t_hi = gapless_bounds(n, info.encoder_delay,
                                            info.encoder_padding)
                t_hi = min(t_hi, n)
            else:
                t_lo, t_hi = 0, n
            skip, end = (t_lo, t_hi) if gapless and info.gapless else (0, n)
            out[i] = _DecodedStream(
                dev=dev, row=k, host=None, n=n, skip=skip, end=end,
                t_lo=t_lo, t_hi=t_hi, nch=metas[i][3], rate=rate, info=info)
        return True

    segs = cfg.d2h_segments
    if segs > 1 and nb % segs == 0 and nb > segs:
        # P4 D2H overlap: K scan dispatches over contiguous window
        # segments (state threads through — bit-identical to the single
        # scan), with each finished segment's PCM download started
        # asynchronously while the next segment computes. Fully-padded
        # segments are never dispatched, and the last live segment is
        # trimmed on device so pad windows are never downloaded.
        per = nb // segs
        parts = []
        st = state
        for j in range(segs):
            lo = j * per
            live = min(n_win - lo, per)   # windows with real content
            if live <= 0:
                break                     # rest is bucket padding
            pcm_j, st = _scan(lo, per, st)
            if live < per:
                pcm_j = pcm_j[:, : live * win * 576]
            try:
                pcm_j.copy_to_host_async()
            except Exception:
                pass
            parts.append(pcm_j)
        pcm = np.concatenate([np.asarray(p) for p in parts], axis=1)
    else:
        pcm_dev, _st = _scan(0, nb, state)
        # slice the bucket padding off ON DEVICE before the transfer,
        # so pad windows are never downloaded
        pcm = np.asarray(pcm_dev[:, : n_win * win * 576])  # [S, Gpad*576, 2]

    from .dsp.gapless import gapless_bounds
    for k, i in enumerate(chunk):
        nch = metas[i][3]
        n = Gs[k] * 576
        info = metas[i][1]
        if gapless and info.gapless:
            # bounds from the ORIGINAL container parse — the body bytes
            # here have the metadata frame stripped
            skip, end = gapless_bounds(n, info.encoder_delay,
                                       info.encoder_padding)
        else:
            skip, end = 0, None
        hi = n if end is None else min(n, end)
        out[i] = (pcm[k, skip:hi, :nch].copy(), rate)
    return True


def decode_symbols_chunked(st: SymbolTensors, chunk_granules: int = 128,
                           halo: int = 2, output: str = "float32") -> np.ndarray:
    """Sequence-parallel decode of ONE long stream (SURVEY.md P3, §5.7).

    The granule chain is finite-window linear: IMDCT overlap-add couples
    adjacent granules and the synthesis FIR reads 15 prior steps — both
    inside a 2-granule halo. So a long file is decoded as a BATCH of
    independent chunks, each pre-rolled with `halo` redundant granules
    whose output is discarded. One device call decodes the whole file;
    no collectives, no scan — the ring-attention analog is a static halo
    (SURVEY.md §2.4 P3).

    output="int16" quantizes INSIDE the same dispatch and downloads 4x
    fewer bytes. Quantization is
    elementwise, so slicing commutes with it; the only delta vs
    quantize_i16 of the float output is that XLA may fuse the combined
    program's float arithmetic differently (<=1 LSB at rounding
    boundaries on an accelerator backend; the CPU backend compiles both
    identically). Same <=1 LSB decode contract
    as every other path.
    """
    G = st.n_granules
    n_chunks = max(1, -(-G // chunk_granules))
    W = halo + chunk_granules
    S = n_chunks

    def gather(a, fill=0):
        out = np.zeros((S, W) + a.shape[1:], a.dtype)
        for c in range(n_chunks):
            lo = c * chunk_granules - halo
            for w in range(W):
                g = lo + w
                if 0 <= g < G:
                    out[c, w] = a[g]
        return jnp.asarray(out)

    fn = kp.decode_window_i16 if output == "int16" else kp.decode_window
    args = (gather(st.is_), gather(st.exp), gather(st.block_type),
            gather(st.mixed), gather(st.smode))
    # Chunks are mutually independent (that IS the halo design), so
    # split the batch into segments and start each segment's D2H
    # asynchronously while the next one computes. The default K=2 keeps
    # the extra executable count at one; odd/small batches take the
    # single dispatch; decode.d2h_segments_single=1 disables the split.
    from .config import get_active
    segs = max(1, int(get_active().decode.d2h_segments_single))
    if segs > 1 and S >= 2 * segs and S % segs == 0:
        parts = []
        per = S // segs
        for j in range(segs):
            sl = slice(j * per, (j + 1) * per)
            p, _ = fn(*(a[sl] for a in args), kp.init_state(per),
                      st.sample_rate)
            try:
                p.copy_to_host_async()
            except Exception:
                pass
            parts.append(p)
        pcm = np.concatenate([np.asarray(p) for p in parts], axis=0)
    else:
        pcm, _ = fn(*args, kp.init_state(S), st.sample_rate)
        pcm = np.asarray(pcm)
    pcm = pcm[:, halo * 576:]                      # drop halo output
    out = pcm.reshape(S * chunk_granules * 576, 2)[: G * 576]
    return out[:, : st.channels]
