"""Batched decode pipeline (SURVEY.md C1-C8, L2).

One jittable pure function maps dense SymbolTensors onto PCM for a whole
[stream, granule] window at once:

  requantize -> stereo mix -> (reorder+alias as one constant matmul) ->
  IMDCT/window -> overlap-add -> frequency inversion -> polyphase
  synthesis (16-tap FIR over granule time-steps) -> PCM

Formulation (SURVEY.md §7.3):
  * no data-dependent gathers — every table lookup is a small one-hot
    matmul and every permutation/selection a constant matrix:
      - short-block reorder + alias butterflies: composed into one
        [576,576] matrix per block flavor (built by probing the float64
        oracle with an identity basis — structurally exact);
      - band-exponent and stereo-matrix expansion: one-hot [64->576]
        matmuls per flavor, selected by flavor one-hots;
      - |is|^(4/3): computed (cbrt + one Newton step) instead of a LUT.
    Every einsum runs at Precision.HIGHEST: float32 operands must not
    be rounded to TF32 (the oracle contract is <=3e-6).
  * granule-parallel everywhere; the two temporal couplings (IMDCT
    overlap-add, synthesis FIFO) are a shift along the granule axis and
    a 16-tap FIR with explicit tiny carried state.

State per stream-channel: overlap [32,18] + synthesis history [15,32]
floats — small, explicit, checkpoint/seek-friendly (SURVEY.md §5.4).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class DeviceTables:
    """Per-samplerate constant tables, device-resident."""
    band_oh: jax.Array      # f32 [3, 64, 576] one-hot band->line expansion
    ra: jax.Array           # f32 [3, 576, 576] reorder+alias composed
    imdct_long: jax.Array   # f32 [18, 36]  (unwindowed IMDCT-36)
    imdct_short: jax.Array  # f32 [18, 36]  (composite windowed short)
    windows: jax.Array      # f32 [4, 36]   (long windows; row 2 = ones)
    palette4: jax.Array     # f32 [144, 4]  stereo mixing palette (flattened 2x2)
    synth_fir: jax.Array    # f32 [16, 32, 32]
    inv_mask: jax.Array     # f32 [32, 18]


@functools.lru_cache(maxsize=None)
def build_tables(sample_rate: int) -> DeviceTables:
    from ..oracle.decoder import alias_reduce
    from ..tables import filterbank as fb
    from ..tables import maps as tmaps
    from ..tables.stereo_palette import PALETTE
    bm, rm = tmaps.get_maps(sample_rate)

    band_oh = np.zeros((3, 64, 576))
    for f in range(3):
        band_oh[f, bm[f], np.arange(576)] = 1.0

    # reorder + alias composed, by linearity, from the oracle stages
    n_bound = {tmaps.FLAVOR_LONG: 31, tmaps.FLAVOR_SHORT: 0, tmaps.FLAVOR_MIXED: 1}
    ra = np.zeros((3, 576, 576))
    eye = np.eye(576)
    for f in range(3):
        nat = eye[:, rm[f]]                      # reorder rows of identity
        for r in range(576):
            ra[f, r] = alias_reduce(nat[r].reshape(32, 18), n_bound[f]).ravel()

    mats = fb.imdct_block_matrices()
    wins = np.stack([fb.imdct_window(0), fb.imdct_window(1),
                     np.ones(36), fb.imdct_window(3)])
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    out = DeviceTables(
        band_oh=f32(band_oh), ra=f32(ra),
        imdct_long=f32(fb.imdct36_matrix()), imdct_short=f32(mats[2]),
        windows=f32(wins), palette4=f32(PALETTE.reshape(-1, 4)),
        synth_fir=f32(fb.synthesis_fir()), inv_mask=f32(inv))
    return out


def init_state(n_streams: int, n_channels: int = 2):
    """Explicit decoder state carried between windows (f32, tiny)."""
    return {
        "overlap": jnp.zeros((n_streams, n_channels, 32, 18), jnp.float32),
        "hist": jnp.zeros((n_streams, n_channels, 15, 32), jnp.float32),
    }


def _pow43(a: jax.Array) -> jax.Array:
    """|is|^(4/3) = a * cbrt(a), cbrt refined by one Newton step (~0.5 ulp)."""
    y = jnp.cbrt(a)
    y2 = y * y
    y = jnp.where(a > 0, y - (y2 * y - a) / (3.0 * y2 + 1e-30), 0.0)
    return a * y


def granule_pipeline(is_, exp, block_type, mixed, smode, state,
                     tables: DeviceTables):
    """Decode a [S, G] window.

    Args:
      is_:  int16/int32 [S, G, 2, 576] quantized spectrum (signed)
      exp:  int16/int32 [S, G, 2, 64] quarter-step band exponents
      block_type: int8/int32 [S, G, 2]
      mixed: bool [S, G, 2]
      smode: uint8 [S, G, 64] stereo-palette index per band
      state: dict from init_state()
      tables: DeviceTables for this stream batch's sample rate
    Returns:
      pcm f32 [S, G*576, 2], new_state
    """
    S, G = is_.shape[:2]
    iv = is_.astype(jnp.float32)
    bt = block_type.astype(jnp.int32)
    short = bt == 2
    fl = jnp.where(short, jnp.where(mixed, 2, 1), 0)          # [S,G,2]
    fl_oh = (fl[..., None] == jnp.arange(3)).astype(jnp.float32)  # [S,G,2,3]

    # ---- C1 requantize: xr = sign * |is|^(4/3) * 2^(exp[band]/4)
    e_flav = jnp.einsum("sgcf,nfi->sgcni", exp.astype(jnp.float32),
                        tables.band_oh, precision=HIGHEST)    # [S,G,2,3,576]
    e_line = jnp.einsum("sgcni,sgcn->sgci", e_flav, fl_oh, precision=HIGHEST)
    xr = jnp.sign(iv) * _pow43(jnp.abs(iv)) * jnp.exp2(0.25 * e_line)

    # ---- C2 stereo: palette-index -> 2x2 matrix (one-hot matmul), then
    # per-line expansion and mixing (band geometry of channel 0)
    oh = (smode[..., None] == jnp.arange(tables.palette4.shape[0])
          ).astype(jnp.float32)                               # [S,G,64,P]
    m_band = jnp.einsum("sgbp,pq->sgbq", oh, tables.palette4,
                        precision=HIGHEST)                    # [S,G,64,4]
    m_flav = jnp.einsum("sgbq,nbi->sgniq", m_band, tables.band_oh,
                        precision=HIGHEST)                    # [S,G,3,576,4]
    m_line = jnp.einsum("sgniq,sgn->sgiq", m_flav, fl_oh[:, :, 0],
                        precision=HIGHEST)                    # [S,G,576,4]
    xr = jnp.stack([m_line[..., 0] * xr[:, :, 0] + m_line[..., 1] * xr[:, :, 1],
                    m_line[..., 2] * xr[:, :, 0] + m_line[..., 3] * xr[:, :, 1]],
                   axis=2)

    # ---- C3+C4 reorder + alias butterflies: one constant matmul/flavor
    nat_f = jnp.einsum("sgci,nij->sgcnj", xr, tables.ra, precision=HIGHEST)
    nat = jnp.einsum("sgcnj,sgcn->sgcj", nat_f, fl_oh, precision=HIGHEST)
    v = nat.reshape(S, G, 2, 32, 18)
    return _imdct_and_backend(v, bt, short, mixed, state, tables, S, G)


def _imdct_and_backend(v, bt, short, mixed, state, tables, S, G):

    # ---- C5 IMDCT + window; per-subband block type (mixed: sb<2 long)
    sb = jnp.arange(32)
    bt_sb = jnp.where(short[..., None] & mixed[..., None]
                      & (sb < 2)[None, None, None, :], 0, bt[..., None])
    win = jnp.einsum("sgcbw,wj->sgcbj",
                     (bt_sb[..., None] == jnp.arange(4)).astype(jnp.float32),
                     tables.windows, precision=HIGHEST)       # [S,G,2,32,36]
    z_long = jnp.einsum("sgcbk,kj->sgcbj", v, tables.imdct_long,
                        precision=HIGHEST)
    z_short = jnp.einsum("sgcbk,kj->sgcbj", v, tables.imdct_short,
                         precision=HIGHEST)
    z = jnp.where((bt_sb == 2)[..., None], z_short, z_long * win)
    return _backend(z, state, tables, S, G)


def _backend(z, state, tables: DeviceTables, S: int, G: int):
    """Overlap-add + frequency inversion + synthesis FIR (C6-C7)."""
    # ---- overlap-add along the granule axis + C6 frequency inversion
    tails = jnp.concatenate(
        [state["overlap"][:, None], z[:, :-1, :, :, 18:]], axis=1)
    s = (z[..., :18] + tails) * tables.inv_mask               # [S,G,2,32,18]
    new_overlap = z[:, -1, :, :, 18:]

    # ---- C7 polyphase synthesis as 16-tap FIR over granule time-steps
    T = G * 18
    seq = s.transpose(0, 2, 1, 4, 3).reshape(S, 2, T, 32)
    full = jnp.concatenate([state["hist"], seq], axis=2)      # [S,2,15+T,32]
    h = jnp.stack([full[:, :, 15 - d: 15 - d + T] for d in range(16)],
                  axis=3)                                     # [S,2,T,16,32]
    pcm = jnp.einsum("sctdk,dkj->sctj", h, tables.synth_fir,
                     precision=HIGHEST)                       # [S,2,T,32]
    new_hist = full[:, :, -15:]

    pcm = pcm.reshape(S, 2, T * 32).transpose(0, 2, 1)        # [S, G*576, 2]
    return pcm, {"overlap": new_overlap, "hist": new_hist}


def quantize_i16(pcm: jax.Array) -> jax.Array:
    """float PCM in [-1, 1) -> int16, round-half-away-from-zero (C8)."""
    scaled = pcm * 32768.0
    r = jnp.where(scaled >= 0, jnp.floor(scaled + 0.5), jnp.ceil(scaled - 0.5))
    return jnp.clip(r, -32768.0, 32767.0).astype(jnp.int16)


@functools.lru_cache(maxsize=None)
def _jitted_for(sample_rate: int, i16: bool = False):
    # tables are built eagerly (outside any trace) and captured as
    # closure constants of the per-samplerate jitted function.
    tables = build_tables(sample_rate)

    @jax.jit
    def run(is_, exp, block_type, mixed, smode, state):
        pcm, st = granule_pipeline(is_, exp, block_type, mixed, smode, state,
                                   tables)
        return (quantize_i16(pcm) if i16 else pcm), st

    return run


def decode_window(is_, exp, block_type, mixed, smode, state, sample_rate: int):
    """jit entry: one decode window at a fixed sample rate (f32 PCM)."""
    return _jitted_for(sample_rate)(is_, exp, block_type, mixed, smode, state)


def decode_window_i16(is_, exp, block_type, mixed, smode, state, sample_rate: int):
    """jit entry: one decode window, int16 PCM out (single dispatch)."""
    return _jitted_for(sample_rate, True)(is_, exp, block_type, mixed, smode, state)


@functools.lru_cache(maxsize=None)
def _jitted_scan_for(sample_rate: int, win: int):
    """Whole-batch decode as one dispatch: lax.scan over granule windows
    (the state carry IS the scan carry), symbols stay device-resident,
    int16 PCM emitted per window to bound memory."""
    tables = build_tables(sample_rate)

    @jax.jit
    def run(is_, exp, block_type, mixed, smode, state):
        S, G = is_.shape[:2]
        n_win = G // win
        # [S, n_win, win, ...] -> scan over windows
        def to_xs(a):
            return a.reshape((a.shape[0], n_win, win) + a.shape[2:]).swapaxes(0, 1)
        xs = tuple(to_xs(a) for a in (is_, exp, block_type, mixed, smode))

        def step(state, x):
            pcm, new_state = granule_pipeline(*x, state, tables)
            return new_state, quantize_i16(pcm)

        state, pcm = jax.lax.scan(step, state, xs)
        # pcm: [n_win, S, win*576, 2] -> [S, G*576, 2]
        return pcm.swapaxes(0, 1).reshape(S, G * 576 * 2 // 2, 2), state

    return run


def decode_batch_scan(is_, exp, block_type, mixed, smode, state, sample_rate: int,
                      win: int = 32):
    """One-dispatch batched decode; G must be a multiple of win."""
    return _jitted_scan_for(sample_rate, win)(is_, exp, block_type, mixed, smode, state)


@functools.lru_cache(maxsize=None)
def _jitted_group_scan_for(sample_rate: int, win: int, k: int):
    """THE single-stream decode program: lax.scan over k windows of
    `win` granules with the {overlap, hist} state carry, float32 PCM
    out [S, k*win*576, 2] in ONE dispatch.

    decode_file and the Player both run this program EXCLUSIVELY, which
    is what makes their PCM bit-identical (XLA numerics are only stable
    within one compiled executable — SURVEY.md §7.5). Two properties of
    the scan make partial work exact with the same program:

    * prefix property: scan step i's PCM depends only on windows <= i,
      so a request for the first m windows can zero-pad the rest and
      the m real windows' PCM is bit-identical to a full-group run;
    * state locality: the carried state after a window is a pure
      function of THAT window's symbols (overlap = z tail, hist = seq
      tail, both derived from the current window only), so a seek
      pre-roll places one real window in the LAST scan slot and takes
      the returned state — O(window) host unpack, one dispatch.
    """
    tables = build_tables(sample_rate)

    @jax.jit
    def run(is_, exp, block_type, mixed, smode, state):
        def to_xs(a):
            return a.reshape((a.shape[0], k, win) + a.shape[2:]).swapaxes(0, 1)
        xs = tuple(to_xs(a) for a in (is_, exp, block_type, mixed, smode))

        def step(st, x):
            pcm, st2 = granule_pipeline(*x, st, tables)
            return st2, pcm

        state, pcm = jax.lax.scan(step, state, xs)
        S = is_.shape[0]
        return pcm.swapaxes(0, 1).reshape(S, k * win * 576, 2), state

    return run


def decode_window_group(is_, exp, block_type, mixed, smode, state,
                        sample_rate: int, k: int):
    """k-window group decode, one dispatch (inputs [S, k*win, ...])."""
    win = is_.shape[1] // k
    return _jitted_group_scan_for(sample_rate, win, k)(
        is_, exp, block_type, mixed, smode, state)


def unpack12(is12, esc_pos, esc_val):
    """Device-side decode of the 12-bit packed spectrum plane.

    is12: uint8 [..., 864]; esc_pos/esc_val: int16/int32 [..., 16]
    (escape line index, -1 = empty / exact value). Returns int32
    [..., 576]."""
    u = is12.astype(jnp.int32).reshape(is12.shape[:-1] + (288, 3))
    a = (u[..., 0] << 4) | (u[..., 1] >> 4)
    b = ((u[..., 1] & 0xF) << 8) | u[..., 2]
    v = jnp.stack([a, b], axis=-1).reshape(is12.shape[:-1] + (576,))
    v = v - 4096 * (v >= 2048)
    return _apply_escapes(v, esc_pos, esc_val)


def _apply_escapes(v, esc_pos, esc_val):
    lines = jnp.arange(576)
    for e in range(esc_pos.shape[-1]):
        p = esc_pos[..., e:e + 1].astype(jnp.int32)
        val = esc_val[..., e:e + 1].astype(jnp.int32)
        v = jnp.where(lines == p, val, v)
    return v


def unpack8(is8, esc_pos, esc_val):
    """Device-side decode of the 8-bit signed spectrum plane.

    is8: int8 [..., 576] (|values| <= 127 inline); esc_pos/esc_val as in
    unpack12 for the rare larger values. Returns int32 [..., 576]."""
    return _apply_escapes(is8.astype(jnp.int32), esc_pos, esc_val)


def unpack4(is4, esc):
    """Device-side decode of the 4-bit packed spectrum plane.

    is4: uint8 [..., 288], two lines per byte, nibble = value+7 for
    values in [-7, 7]; nibble 15 marks an escape. esc int8 [..., 80] is
    the POSITION-FREE two-level sideband: [:64] escape values in line
    order (marker -128 = deep escape), [64:72]/[72:80] low/high bytes
    of the rare |v|>127 values, indexed by rank among -128 markers.
    Each rank lookup is a one-hot matvec (no data-dependent gather, as
    everywhere in this module). Returns int32 [..., 576]."""
    e8 = esc[..., :64].astype(jnp.int32)
    deep = e8 == -128
    lo = esc[..., 64:72].astype(jnp.int32) & 255
    hi = esc[..., 72:80].astype(jnp.int32)
    big_vals = (hi << 8) + lo
    rank2 = jnp.cumsum(deep.astype(jnp.int32), axis=-1) - 1
    oh2 = ((rank2[..., None] == jnp.arange(8)) & deep[..., None])
    deep_contrib = jnp.einsum("...eb,...b->...e", oh2.astype(jnp.float32),
                              big_vals.astype(jnp.float32),
                              precision=HIGHEST).astype(jnp.int32)
    esc_val = jnp.where(deep, deep_contrib, e8)

    u = is4.astype(jnp.int32)
    nib = jnp.stack([u & 15, u >> 4], axis=-1).reshape(is4.shape[:-1] + (576,))
    is_esc = nib == 15
    base = jnp.where(is_esc, 0, nib - 7)
    rank = jnp.cumsum(is_esc.astype(jnp.int32), axis=-1) - 1
    oh = ((rank[..., None] == jnp.arange(64)) & is_esc[..., None])
    contrib = jnp.einsum("...ie,...e->...i", oh.astype(jnp.float32),
                         esc_val.astype(jnp.float32), precision=HIGHEST)
    return base + contrib.astype(jnp.int32)


def _exp_decode(exp):
    """Expand the compact uint8[..., 65] exponent plane ([gg, off+128]
    per gc; exp = gg - 210 + off) back to int32 [..., 64]; int16 planes
    pass through. Shape-static, so free under jit."""
    if exp.shape[-1] == 65:
        e = exp.astype(jnp.int32)
        return (e[..., :1] - 210) + (e[..., 1:] - 128)
    return exp


def _plane_decode(plane_bits: int, is12, esc):
    """Dispatch packed-plane decode; esc is the staged sideband tensor
    ([..., n, 2] pos/val pairs for 8/12-bit, [..., 64] values for
    4-bit)."""
    if plane_bits == 4:
        return unpack4(is12, esc)
    fn = unpack12 if plane_bits == 12 else unpack8
    return fn(is12, esc[..., 0], esc[..., 1])


@functools.lru_cache(maxsize=None)
def _jitted_packed_for(sample_rate: int, plane_bits: int = 12):
    tables = build_tables(sample_rate)

    @jax.jit
    def run(is12, esc, exp, block_type, mixed, smode, state):
        iv = _plane_decode(plane_bits, is12, esc)
        pcm, st = granule_pipeline(iv, _exp_decode(exp), block_type, mixed,
                                   smode, state, tables)
        return quantize_i16(pcm), st

    return run


def decode_window_packed_i16(is12, esc, exp, block_type, mixed,
                             smode, state, sample_rate: int,
                             plane_bits: int = 12):
    """jit entry consuming the packed spectrum plane (12-bit: 2.1x fewer
    host->device bytes than the int16 plane; 8-bit: 3.2x; 4-bit: 4.6x).
    esc: [..., n, 2] pos/val sideband (8/12-bit) or [..., 64] position-
    free values (4-bit)."""
    return _jitted_packed_for(sample_rate, plane_bits)(
        is12, esc, exp, block_type, mixed, smode, state)


@functools.lru_cache(maxsize=None)
def _jitted_packed_resample_for(sample_rate: int, out_rate: int,
                                plane_bits: int = 12):
    """Packed decode + polyphase resample fused in one dispatch
    (BASELINE config 3: batched decode + resample to 48 kHz)."""
    from ..dsp.resample import Resampler
    tables = build_tables(sample_rate)
    rs = Resampler(sample_rate, out_rate)
    L, M, state_len = rs.L, rs.M, rs.state_len
    n_taps, width, block_w = rs.n_taps, rs.block_width, rs.block_w

    @jax.jit
    def run(is12, esc, exp, block_type, mixed, smode, state,
            rs_state):
        iv = _plane_decode(plane_bits, is12, esc)
        pcm, st = granule_pipeline(iv, _exp_decode(exp), block_type, mixed,
                                   smode, state, tables)
        S = pcm.shape[0]
        x = jnp.concatenate([rs_state, pcm], axis=1)    # [S, hist+T, 2]
        N = x.shape[1]
        # block-Toeplitz polyphase (see dsp.resample.Resampler): M inputs
        # (+context) -> L outputs via one [L, width] constant matrix —
        # a plain strided conv, ~20x faster than the input-dilated form
        out_len = ((N - 1) * L + 1 - n_taps) // M + 1
        nblk = -(-out_len // L)
        npad = (nblk - 1) * M + width
        xp = jnp.pad(x, ((0, 0), (0, max(0, npad - N)), (0, 0)))
        lhs = xp.transpose(0, 2, 1).reshape(S * 2, 1, npad)
        out = jax.lax.conv_general_dilated(
            lhs, block_w[:, None, :], window_strides=(M,), padding=[(0, 0)],
            precision=HIGHEST)                          # [S*2, L, nblk]
        out = out.transpose(0, 2, 1).reshape(S * 2, nblk * L)[:, :out_len]
        out = out.reshape(S, 2, out_len).transpose(0, 2, 1)
        new_rs_state = x[:, -state_len:] if state_len else rs_state
        return quantize_i16(out), st, new_rs_state

    return run, state_len


def decode_window_packed_resampled_i16(is12, esc, exp,
                                       block_type, mixed, smode, state,
                                       rs_state, sample_rate: int,
                                       out_rate: int = 48000,
                                       plane_bits: int = 12):
    run, _ = _jitted_packed_resample_for(sample_rate, out_rate, plane_bits)
    return run(is12, esc, exp, block_type, mixed, smode,
               state, rs_state)


@functools.lru_cache(maxsize=None)
def _jitted_regroup_for(n_groups: int):
    @jax.jit
    def run(is12_gs, exp_gs, esc_gs, bt_gs, mx_gs, sm_gs):
        cat = lambda gs: jnp.concatenate(gs, axis=1)
        return (cat(is12_gs), cat(exp_gs), cat(esc_gs), cat(bt_gs),
                cat(mx_gs), cat(sm_gs))
    return run


def regroup_device(is12_gs, exp_gs, esc_gs, bt_gs, mx_gs, sm_gs):
    """Concatenate staged stream-group tensors [n_win, S/g, ...] into
    whole-batch tensors [n_win, S, ...] in one device pass, so the
    per-window decode step carries no n_groups-way concat in its hot
    loop (staging granularity is a transfer choice, not a shape the
    compute should pay for)."""
    run = _jitted_regroup_for(len(is12_gs))
    return run(tuple(is12_gs), tuple(exp_gs), tuple(esc_gs), tuple(bt_gs),
               tuple(mx_gs), tuple(sm_gs))


@functools.lru_cache(maxsize=None)
def _jitted_scan_all_for(sample_rate: int, out_rate: int,
                         plane_bits: int = 12):
    """All-windows decode + one whole-stream resample as ONE dispatch.

    lax.scan carries only the decode state (overlap + synthesis FIFO)
    over the window axis; the resampler runs ONCE over the concatenated
    f32 PCM (it is a stateless strided conv given its history tail, so
    hoisting it out of the scan is exact and keeps the scan body small,
    which also keeps its compile short)."""
    from ..dsp.resample import Resampler
    tables = build_tables(sample_rate)
    rs = Resampler(sample_rate, out_rate)
    L, M, state_len = rs.L, rs.M, rs.state_len
    n_taps, width, block_w = rs.n_taps, rs.block_width, rs.block_w

    @jax.jit
    def run(is12, exp, esc, bt, mx, sm, state, rs_state):
        def step(st, xs):
            i12, ex, es, b, m, s = xs
            iv = _plane_decode(plane_bits, i12, es)
            pcm, st2 = granule_pipeline(iv, _exp_decode(ex), b,
                                        m.astype(jnp.bool_), s, st, tables)
            return st2, pcm
        st, pcm = jax.lax.scan(step, state, (is12, exp, esc, bt, mx, sm))
        n_win, S, T = pcm.shape[0], pcm.shape[1], pcm.shape[2]
        pcm = pcm.transpose(1, 0, 2, 3).reshape(S, n_win * T, 2)
        x = jnp.concatenate([rs_state, pcm], axis=1)
        N = x.shape[1]
        out_len = ((N - 1) * L + 1 - n_taps) // M + 1
        nblk = -(-out_len // L)
        npad = (nblk - 1) * M + width
        xp = jnp.pad(x, ((0, 0), (0, max(0, npad - N)), (0, 0)))
        lhs = xp.transpose(0, 2, 1).reshape(S * 2, 1, npad)
        out = jax.lax.conv_general_dilated(
            lhs, block_w[:, None, :], window_strides=(M,), padding=[(0, 0)],
            precision=HIGHEST)
        out = out.transpose(0, 2, 1).reshape(S * 2, nblk * L)[:, :out_len]
        out = out.reshape(S, 2, out_len).transpose(0, 2, 1)
        new_rs_state = x[:, -state_len:] if state_len else rs_state
        return quantize_i16(out), st, new_rs_state

    return run


def decode_all_windows_flat_resampled_i16(is12, exp, esc, bt, mx, sm, state,
                                          rs_state, sample_rate: int,
                                          out_rate: int = 48000,
                                          plane_bits: int = 12):
    run = _jitted_scan_all_for(sample_rate, out_rate, plane_bits)
    return run(is12, exp, esc, bt, mx, sm, state, rs_state)


@functools.lru_cache(maxsize=None)
def _jitted_regroup_arena_for(n_groups: int, n_win: int, Sg: int, win: int):
    """Split per-group byte ARENAS (one device_put each) into the six batch
    tensors and concatenate the groups in HBM. Only valid for the all-
    byte plane family (4-bit spectrum, int8 two-level sideband, byte
    exponents)."""
    shapes = (("is12", (n_win, Sg, win, 2, 288), jnp.uint8),
              ("esc", (n_win, Sg, win, 2, 80), jnp.int8),
              ("exp", (n_win, Sg, win, 2, 65), jnp.uint8),
              ("bt", (n_win, Sg, win, 2), jnp.int8),
              ("mx", (n_win, Sg, win, 2), jnp.uint8),
              ("smode", (n_win, Sg, win, 64), jnp.uint8))

    @jax.jit
    def run(arenas):
        outs = []
        off = 0
        parts = {k: [] for k, _, _ in shapes}
        for a in arenas:
            off = 0
            for k, shp, dt in shapes:
                n = int(np.prod(shp))
                sec = jax.lax.slice(a, (off,), (off + n,))
                if dt != jnp.uint8:
                    sec = jax.lax.bitcast_convert_type(sec, dt)
                parts[k].append(sec.reshape(shp))
                off += n
        return tuple(jnp.concatenate(parts[k], axis=1)
                     for k, _, _ in shapes)

    return run


def arena_layout(n_win: int, Sg: int, win: int):
    """(total_bytes, [(key, offset, shape, numpy dtype)]) of the packed
    per-group staging arena (all-byte plane family)."""
    shapes = (("is12", (n_win, Sg, win, 2, 288), np.uint8),
              ("esc", (n_win, Sg, win, 2, 80), np.int8),
              ("exp", (n_win, Sg, win, 2, 65), np.uint8),
              ("bt", (n_win, Sg, win, 2), np.int8),
              ("mx", (n_win, Sg, win, 2), np.uint8),
              ("smode", (n_win, Sg, win, 64), np.uint8))
    out = []
    off = 0
    for k, shp, dt in shapes:
        out.append((k, off, shp, dt))
        off += int(np.prod(shp))
    return off, out


def regroup_device_arenas(arenas, n_win: int, Sg: int, win: int):
    """One device pass: per-group staging arenas -> the six whole-batch
    window-major tensors (matches regroup_device's output order)."""
    run = _jitted_regroup_arena_for(len(arenas), n_win, Sg, win)
    return run(tuple(arenas))


@functools.lru_cache(maxsize=None)
def _jitted_scan_plain_for(sample_rate: int, plane_bits: int, n_win: int):
    """All-windows packed decode as ONE dispatch (no resample): the
    per-window arrays arrive as tuples (each staged as its own <=2 MB
    transfer), are stacked inside the program, and a lax.scan carries
    the decode state — one dispatch per batch instead of one per
    window."""
    tables = build_tables(sample_rate)

    @jax.jit
    def run(is12_w, esc_w, exp_w, bt_w, mx_w, sm_w, state):
        xs = tuple(jnp.stack(a) for a in
                   (is12_w, esc_w, exp_w, bt_w, mx_w, sm_w))

        def step(st, x):
            i12, es, ex, b, m, sm = x
            iv = _plane_decode(plane_bits, i12, es)
            pcm, st2 = granule_pipeline(iv, _exp_decode(ex), b,
                                        m.astype(jnp.bool_), sm, st, tables)
            return st2, quantize_i16(pcm)

        st, pcm = jax.lax.scan(step, state, xs)
        S, T = pcm.shape[1], pcm.shape[2]
        return pcm.transpose(1, 0, 2, 3).reshape(S, n_win * T, 2), st

    return run


def decode_windows_scan_i16(is12_w, esc_w, exp_w, bt_w, mx_w, sm_w, state,
                            sample_rate: int, plane_bits: int = 4):
    """One-dispatch packed decode of a window sequence (tuples of
    per-window arrays, all the same [S, win, ...] shape)."""
    run = _jitted_scan_plain_for(sample_rate, plane_bits, len(is12_w))
    return run(tuple(is12_w), tuple(esc_w), tuple(exp_w), tuple(bt_w),
               tuple(mx_w), tuple(sm_w), state)


def window_arena_layout(S: int, win: int):
    """(total_bytes, [(key, offset, shape, numpy dtype)]) of ONE
    device-window's packed staging arena covering the whole chunk width
    S (all-byte plane family: 4-bit spectrum + int8 two-level sideband +
    byte exponents). The public fast path ships each window as ONE
    contiguous uint8 put (~S*win*934 bytes, <=2 MB at S=64/win=32)
    instead of six arrays; the split back into planes happens inside the
    jitted scan program."""
    shapes = (("is12", (S, win, 2, 288), np.uint8),
              ("esc", (S, win, 2, 80), np.int8),
              ("exp", (S, win, 2, 65), np.uint8),
              ("bt", (S, win, 2), np.int8),
              ("mx", (S, win, 2), np.uint8),
              ("smode", (S, win, 64), np.uint8))
    out = []
    off = 0
    for k, shp, dt in shapes:
        out.append((k, off, shp, dt))
        off += int(np.prod(shp))
    return off, out


def _split_window_arena(a, S: int, win: int):
    """In-program split of one window arena back into the six plane
    tensors (order matches decode_windows_scan_i16's argument order)."""
    _, layout = window_arena_layout(S, win)
    parts = {}
    for k, off, shp, dt in layout:
        n = int(np.prod(shp))
        sec = jax.lax.slice(a, (off,), (off + n,))
        if dt != np.uint8:
            sec = jax.lax.bitcast_convert_type(sec, jnp.int8)
        parts[k] = sec.reshape(shp)
    return parts


@functools.lru_cache(maxsize=None)
def _jitted_scan_arena_for(sample_rate: int, n_win: int, S: int, win: int):
    """All-windows packed decode as ONE dispatch from per-window byte
    ARENAS: each window arrives as one contiguous uint8 buffer (one
    device_put each), is split into the six plane tensors and stacked
    inside the program, and a lax.scan carries the decode state — the
    same step as _jitted_scan_plain_for (4-bit plane family), so batch
    output is bit-identical to the per-plane staging path."""
    tables = build_tables(sample_rate)

    @jax.jit
    def run(arenas, state):
        planes = [_split_window_arena(a, S, win) for a in arenas]
        xs = tuple(jnp.stack([p[k] for p in planes])
                   for k in ("is12", "esc", "exp", "bt", "mx", "smode"))

        def step(st, x):
            i12, es, ex, b, m, sm = x
            iv = _plane_decode(4, i12, es)
            pcm, st2 = granule_pipeline(iv, _exp_decode(ex), b,
                                        m.astype(jnp.bool_), sm, st, tables)
            return st2, quantize_i16(pcm)

        st, pcm = jax.lax.scan(step, state, xs)
        return pcm.transpose(1, 0, 2, 3).reshape(S, n_win * pcm.shape[2], 2), st

    return run


def decode_window_arenas_i16(arenas, state, sample_rate: int,
                             S: int, win: int):
    """One-dispatch packed decode of a window sequence staged as per-
    window byte arenas (window_arena_layout; 4-bit plane family only)."""
    run = _jitted_scan_arena_for(sample_rate, len(arenas), S, win)
    return run(tuple(arenas), state)


def init_resample_state(n_streams: int, sample_rate: int,
                        out_rate: int = 48000, n_channels: int = 2):
    from ..dsp.resample import Resampler
    rs = Resampler(sample_rate, out_rate)
    return jnp.zeros((n_streams, rs.state_len, n_channels), jnp.float32)
