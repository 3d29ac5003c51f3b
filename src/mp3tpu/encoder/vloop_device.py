"""Device lockstep rate & distortion loops (SURVEY.md E4, §3.4).

The batched encoder's throughput core: the outer distortion loop and
inner rate bisection run as ONE jitted dispatch per block-type group —
fixed trip counts (bisection over gg in [0,255] is <= 8 steps; the
outer loop is masked fori over its max_iters) with per-row convergence
masks, so XLA sees static control flow (SURVEY.md §7.3).

Division of labor (the lockstep invariant, memory/encoder-lockstep):
  * the DEVICE searches (global_gain, scalefactors, subblock_gain) in
    f32 — approximate at quantization-boundary ulps vs the f64 scalar
    reference (a ±half-step rounding choice, still a valid quantizer);
  * the DEVICE's final quantize at the chosen parameters IS the
    emitted spectrum, and its integer bit count / table selection is
    EXACT for that spectrum (integer math in f32's exact range,
    bit-for-bit vcount/emitter parity — tested). The bisection
    guarantee bits <= budget therefore transfers to emission directly:
    count == emit, the contract the reservoir replay relies on.
  * the HOST keeps all loop CONTROL (budgets, reservoir walks,
    overdraft guards — SURVEY.md §7.5-5).

The numpy vloop (scalar-exact) remains the reference and the CPU path
of single-stream encode_pcm; encode_batch uses this module.

Bit counting here mirrors vcount.count_bits_rows_full: per-pair
clamped-bin histogramming against the [289, T+1] length matrix becomes
a LUT gather + region-masked einsum; table validity comes from region
maxima (plain: max < xl; escape: overflow bit-length <= linbits;
table 0: region all-zero) — no penalty matrix needed on device.
"""
from __future__ import annotations

import functools

import numpy as np

from ..tables import huffman as ht
from ..tables.sfb import LONG, SLEN1, SLEN2
from .quantize import IX_MAX, MAGIC
from .vcount import TABLE_IDS, N_PLAIN, _hist_matrix, _long_region_tables

SPF = 576
HIGHEST = "highest"   # jax.lax.Precision: float32 products, never TF32
_SLEN1 = np.asarray(SLEN1, np.int64)
_SLEN2 = np.asarray(SLEN2, np.int64)

# Row blocking per backend: (CHUNK rows per lax.map step, MACRO rows per
# dispatch). Blocks are FIXED per backend so every batch size reuses the
# same compiled programs.
#   cpu: small blocks (tests).
#   gpu: H100 (700 W), encode_batch 64 x 10 s warm: 2.47 s at 2048/8192,
#        2.59 s at 1024/4096, 3.21 s at 512/2048; a compare-reduce
#        histogram count form lost to the LUT gather at each size (2.73,
#        2.81, 3.23 s) and was removed (PERF.md, Findings).
_DIMS = {
    "cpu": (256, 512),
    "gpu": (2048, 8192),
}


def _dims():
    """(CHUNK, MACRO) for JAX's default backend."""
    import jax
    backend = jax.default_backend()
    try:
        return _DIMS[backend]
    except KeyError:
        raise ValueError(f"no rate-loop blocking for backend {backend!r} "
                         f"(known: {sorted(_DIMS)})") from None


@functools.lru_cache(maxsize=None)
def _device_consts(sample_rate: int):
    import jax.numpy as jnp
    M, _ovp, M_len, _M_bad, _ovb = _hist_matrix()
    T = len(TABLE_IDS)
    # per-table validity params
    xl = np.zeros(T, np.int32)
    linbits = np.zeros(T, np.int32)
    for col, tid in enumerate(TABLE_IDS):
        if tid == 0:
            xl[col] = 1          # codes only zeros
            continue
        _l, _c, x, _y, lb = ht.table_arrays(tid)
        xl[col] = x
        linbits[col] = lb if col >= N_PLAIN else 0
    is_esc = np.arange(T) >= N_PLAIN
    r1p, r2p = _long_region_tables(sample_rate)
    bands = LONG[sample_rate]
    band_of_line = np.zeros(576, np.int64)
    for b in range(21):
        band_of_line[bands[b]:bands[b + 1]] = b
    band_of_line[bands[21]:] = 21
    ind21 = np.zeros((576, 22), np.float32)
    ind21[np.arange(576), band_of_line] = 1.0
    from ..tables import maps as tmaps
    bm = tmaps.band_map(sample_rate, tmaps.FLAVOR_SHORT)
    wline = (bm - 22) // 13
    sline = (bm - 22) % 13
    flat39 = wline * 13 + sline
    ind39 = np.zeros((576, 39), np.float32)
    ind39[np.arange(576), np.minimum(flat39, 38)] = 1.0
    from ..tables.huffman import COUNT1A_LENS
    c1a = np.asarray(COUNT1A_LENS, np.int32)
    pop4 = np.array([bin(i).count("1") for i in range(16)], np.int32)
    f = lambda a, dt: jnp.asarray(a, dt)
    return dict(
        M_len=f(M_len, jnp.float32),            # [289, T+1]
        xl=f(xl, jnp.int32), linbits=f(linbits, jnp.int32),
        is_esc=f(is_esc, jnp.bool_),
        r1p=f(r1p, jnp.int32), r2p=f(r2p, jnp.int32),
        ind21=f(ind21, jnp.float32), ind39=f(ind39, jnp.float32),
        band_of_line=f(np.minimum(band_of_line, 21), jnp.int32),
        wline=f(wline, jnp.int32), sline=f(sline, jnp.int32),
        c1a_sig=f(c1a + pop4, jnp.int32), c1b_sig=f(4 + pop4, jnp.int32),
        slen1=f(_SLEN1, jnp.int32), slen2=f(_SLEN2, jnp.int32),
    )


def _count_rows(jnp, C, ix, short_split: bool):
    """Exact big_values+count1 bit count for quantized rows [R,576] i32.

    Integer-exact: lengths <= 19, at most 288 pairs per region, all sums
    well inside f32's 2^24 integer range (products at HIGHEST precision,
    so no TF32 operand rounding). Mirrors vcount row-for-row."""
    a = jnp.abs(ix[:, 0::2])
    b = jnp.abs(ix[:, 1::2])
    R = ix.shape[0]
    nz = (a | b) > 0
    big = jnp.maximum(a, b) > 1
    anynz = nz.any(1)
    rzp = jnp.where(anynz, 288 - jnp.argmax(nz[:, ::-1], axis=1), 0)
    rzp = rzp + (rzp & 1)
    anybig = big.any(1)
    bigp = jnp.where(anybig, 288 - jnp.argmax(big[:, ::-1], axis=1), 0)
    k = (rzp - bigp) // 2
    bv = rzp - 2 * k                      # big-values region in pairs
    if short_split:
        r1 = jnp.minimum(18, bv)
        r2 = bv
    else:
        r1 = C["r1p"][bv]
        r2 = C["r2p"][bv]

    pidx = jnp.arange(288, dtype=jnp.int32)
    rid = ((pidx[None] >= r1[:, None]).astype(jnp.int32)
           + (pidx[None] >= r2[:, None]) + (pidx[None] >= bv[:, None]))

    bins = jnp.minimum(a, 16) * 17 + jnp.minimum(b, 16)
    # per-pair LUT gather, then a region-masked sum
    Mp = C["M_len"][bins]                               # [R, 288, T+1]
    reg_oh = (rid[:, :, None] == jnp.arange(3)[None, None]).astype(
        jnp.float32)
    region = jnp.einsum("rpt,rps->rst", Mp, reg_oh,
                        precision=HIGHEST)              # [R, 3, T+1]
    bits_t = region[:, :, :-1]
    signs = region[:, :, -1]

    # validity from region maxima
    mxab = jnp.maximum(a, b)
    mxr = jnp.max(jnp.where(rid[:, :, None] == jnp.arange(3)[None, None],
                            mxab[:, :, None], 0), axis=1)        # [R, 3]
    ov = jnp.maximum(mxab - 15, 0)
    # integer bit length via comparison ladder (f32 log2 is unsafe here)
    bl = jnp.zeros_like(ov)
    for kk in range(14):
        bl = bl + (ov > ((1 << kk) - 1)).astype(ov.dtype)
    blr = jnp.max(jnp.where(rid[:, :, None] == jnp.arange(3)[None, None],
                            bl[:, :, None], 0), axis=1)          # [R, 3]
    xl = C["xl"][None, None]               # [1,1,T]
    lb = C["linbits"][None, None]
    esc = C["is_esc"][None, None]
    valid = jnp.where(
        esc, blr[:, :, None] <= lb,
        mxr[:, :, None] < xl)              # plain (and table 0: xl=1)
    reg_cost = jnp.where(valid, bits_t, jnp.float32(1 << 26))
    selr = jnp.argmin(reg_cost, axis=2)                      # [R, 3]
    regmin = jnp.min(reg_cost, axis=2)
    total = jnp.sum(regmin + signs, axis=1)

    # count1: k quads on the quad grid after bv pairs
    nzq = (ix != 0).reshape(R, 144, 4)
    idxq = ((nzq[..., 0] << 3) | (nzq[..., 1] << 2)
            | (nzq[..., 2] << 1) | nzq[..., 3]).astype(jnp.int32)
    csa = jnp.cumsum(C["c1a_sig"][idxq], axis=1)
    csb = jnp.cumsum(C["c1b_sig"][idxq], axis=1)
    csa = jnp.concatenate([jnp.zeros((R, 1), csa.dtype), csa], axis=1)
    csb = jnp.concatenate([jnp.zeros((R, 1), csb.dtype), csb], axis=1)
    q0 = bv // 2
    q1 = q0 + k
    rows = jnp.arange(R)
    ca = csa[rows, q1] - csa[rows, q0]
    cb = csb[rows, q1] - csb[rows, q0]
    total = total + jnp.minimum(ca, cb).astype(jnp.float32)
    c1sel = (ca > cb).astype(jnp.int8)     # vcount tie-break: A on equal
    return total.astype(jnp.int32), selr, bv, k, c1sel


def _quantize(jnp, p34, sign, gg):
    scale = jnp.exp2(-0.75 * (gg[:, None].astype(jnp.float32) - 210.0) / 4.0)
    ix = jnp.floor(p34 * scale + jnp.float32(MAGIC)).astype(jnp.int32)
    return sign * ix


# gg search window for outer-loop iterations >= 2 (docs/rate_loop_notes
# .md): the fitting gg only moves a little per outer iteration (amp
# rises in a few bands; ~2 gg steps per scalefactor step), so after the
# first full-range bisection the search runs over [gg_lo, gg_lo+31] in
# 5 count-kernel steps instead of [gg_lo, 255] in 8. A window-exhausted
# row ("capped") advances its bound by the window and retries next
# iteration without amplifying — same final semantics, implemented
# identically in quantize.py / vloop.py / here (canonical constant in
# quantize.GG_WINDOW).
from .quantize import GG_WINDOW  # noqa: E402
_WINDOW_STEPS = 5    # ceil(log2(GG_WINDOW))


def _inner_bisect(jnp, C, p34, sign, budgets, lo0, short_split: bool,
                  window: int | None = None):
    """Fixed-step bisection for the smallest fitting gg per row, over
    [lo, 255] (8 steps; window=None) or [lo, lo+window-1] (5 steps).

    Returns (gg [R] i32, has_best [R] bool, capped [R] bool,
    next_lo [R] i32): capped = window exhausted below 255 with no fit
    (the caller advances gg_lo to next_lo and retries); next_lo =
    min(adjusted_lo + window, 255)."""
    import jax
    R = p34.shape[0]
    amax34 = jnp.max(p34, axis=1)
    # closed form of the scalar "+4 stepping" lower bound: smallest
    # lo0+4k with amax34 * 2^(-0.75(lo-210)/4) <= IX_MAX
    # <=> lo >= 210 + (4/0.75) * log2(amax34 / IX_MAX)
    need = 210.0 + (16.0 / 3.0) * (jnp.log2(jnp.maximum(amax34, 1e-30))
                                   - jnp.log2(jnp.float32(IX_MAX)))
    ksteps = jnp.maximum(jnp.ceil((need - lo0.astype(jnp.float32)) / 4.0), 0.0)
    lo = jnp.where(amax34 > 0,
                   jnp.minimum(lo0 + 4 * ksteps.astype(jnp.int32), 255),
                   lo0).astype(jnp.int32)
    if window is None:
        hi = jnp.full((R,), 255, jnp.int32)
        steps = 8
    else:
        hi = jnp.minimum(lo + (window - 1), 255)
        steps = _WINDOW_STEPS
    hi0 = hi
    adj_lo = lo
    best = jnp.full((R,), 210, jnp.int32)
    has = jnp.zeros((R,), jnp.bool_)

    def body(_i, carry):
        lo, hi, best, has = carry
        act = lo <= hi
        mid = (lo + hi) // 2
        ix = _quantize(jnp, p34, sign, mid)
        over = jnp.max(jnp.abs(ix), axis=1) > IX_MAX
        bits, _selr, _bv, _k, _c1 = _count_rows(jnp, C, ix, short_split)
        fits = act & ~over & (bits <= budgets)
        best = jnp.where(fits, mid, best)
        has = has | fits
        hi = jnp.where(fits, mid - 1, hi)
        lo = jnp.where(act & ~fits, mid + 1, lo)
        return lo, hi, best, has

    lo, hi, best, has = jax.lax.fori_loop(0, steps, body,
                                          (lo, hi, best, has))
    capped = ~has & (hi0 < 255)
    next_lo = jnp.minimum(adj_lo + (window or 0), 255)
    return jnp.where(has, best, 210), has, capped, next_lo


@functools.lru_cache(maxsize=None)
def _jit_outer_long(sample_rate: int, max_iters: int,
                    switched: bool = False, jump: bool = True):
    """switched=True counts with the window-switched 2-region split
    (start/stop granules, block types 1/3 — long spectrum + long sfb
    shaping, switched Huffman regions). jump=True uses the gap-halving
    scalefactor step (quantize.sf_jump_default; same f32-formula rule
    as the host loops' sf_jump_steps)."""
    import jax
    import jax.numpy as jnp
    C = _device_consts(sample_rate)
    CHUNK, _MACRO = _dims()

    def one_chunk(args):
        xr, xmin, budget_bits = args
        p34_base = jnp.abs(xr) ** 0.75
        sign = jnp.sign(xr).astype(jnp.int32)
        R = xr.shape[0]
        sf_cap = jnp.asarray([15] * 11 + [7] * 10, jnp.int32)
        bol = C["band_of_line"]            # [576] 0..21

        def body_w(window):
            def body(_i, carry):
                sf, gg_lo, done, best_gg, best_sf, has_best, it = carry
                it = it + (~done).astype(it.dtype)   # per-row active iters
                # scalefactor side-info cost (vector argmin over the 16
                # scalefac_compress codes)
                m1 = jnp.max(sf[:, :11], axis=1)
                m2 = jnp.max(sf[:, 11:21], axis=1)
                need1 = jnp.zeros_like(m1)
                need2 = jnp.zeros_like(m2)
                for kk in range(1, 5):
                    need1 = jnp.where(m1 >= (1 << (kk - 1)), kk, need1)
                    need2 = jnp.where(m2 >= (1 << (kk - 1)), kk, need2)
                ok = (C["slen1"][None] >= need1[:, None]) & \
                     (C["slen2"][None] >= need2[:, None])
                cost = 11 * C["slen1"] + 10 * C["slen2"]
                sfc = jnp.argmin(jnp.where(ok, cost[None], 1 << 30), axis=1)
                sfbits = 11 * C["slen1"][sfc] + 10 * C["slen2"][sfc]
                budget = budget_bits - sfbits
                done = done | (budget < 0)

                sf21 = jnp.concatenate(
                    [sf, jnp.zeros((R, 1), sf.dtype)], axis=1)  # band 21 = 0
                amp_line = jnp.exp2(sf21[:, bol].astype(jnp.float32) / 2.0)
                p34 = p34_base * amp_line ** 0.75
                gg, has, capped, next_lo = _inner_bisect(
                    jnp, C, p34, sign, budget, gg_lo, switched, window)
                upd = ~done & has
                best_gg = jnp.where(upd, gg, best_gg)
                best_sf = jnp.where(upd[:, None], sf, best_sf)
                has_best = has_best | upd
                gg_lo = jnp.where(~done,
                                  jnp.where(capped, next_lo, gg), gg_lo)

                # distortion per band at the found quantization
                ix = _quantize(jnp, p34, sign, gg)
                deq = (jnp.abs(ix).astype(jnp.float32) ** (4.0 / 3.0)) * \
                    jnp.exp2((gg[:, None].astype(jnp.float32) - 210.0)
                             / 4.0) / amp_line
                err = (jnp.abs(xr) - deq) ** 2
                dist = jnp.matmul(err, C["ind21"],
                                  precision=HIGHEST)[:, :21]
                over = (dist > xmin) & (sf < sf_cap[None]) & \
                    ~done[:, None] & has[:, None]
                # a window-capped row is not converged — it retries the
                # gg search next iteration from next_lo, unamplified
                done = done | ~(over.any(1) | capped)
                if jump:
                    ratio = jnp.clip(dist / jnp.maximum(xmin, 1e-37),
                                     1.0, 2.0 ** 60)
                    k = jnp.floor(0.5 * jnp.log2(ratio)).astype(sf.dtype)
                    k = jnp.clip(k, 1, jnp.maximum(sf_cap[None] - sf, 1))
                else:
                    k = jnp.ones((), sf.dtype)
                sf = sf + jnp.where(over, k, 0)
                return sf, gg_lo, done, best_gg, best_sf, has_best, it
            return body

        sf0 = jnp.zeros((R, 21), jnp.int32)
        init = (sf0, jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.bool_),
                jnp.full((R,), 210, jnp.int32), sf0,
                jnp.zeros((R,), jnp.bool_), jnp.zeros((R,), jnp.int32))
        # iteration 1: full-range gg bisection (8 steps); iterations
        # >= 2 ride the GG_WINDOW bisection (5 steps) — the fitting gg
        # moves little between outer iterations (docs/rate_loop_notes)
        carry1 = body_w(None)(0, init)
        # early-exit while_loop: iterations after every row converges are
        # exact no-ops (all updates are masked by `done`, including the
        # per-row iteration counter), so stopping at all(done) is
        # bit-identical to the fixed-depth fori_loop while skipping the
        # tail iterations (typ. convergence << max_iters)
        _i, (_sf, _gl, done_end, best_gg, best_sf, has_best, iters) = \
            jax.lax.while_loop(
                lambda c: (c[0] < max_iters) & ~jnp.all(c[1][2]),
                lambda c: (c[0] + 1, body_w(GG_WINDOW)(c[0], c[1])),
                (jnp.int32(1), carry1))
        # rows that never fit under shaping: plain rate loop, sf = 0
        gg_fb, has_fb, _c, _n = _inner_bisect(
            jnp, C, p34_base, sign, budget_bits,
            jnp.zeros((R,), jnp.int32), switched)
        best_gg = jnp.where(has_best, best_gg, gg_fb)
        best_sf = jnp.where(has_best[:, None], best_sf, 0)
        has_any = has_best | has_fb
        # final quantize + exact count at the chosen parameters (the
        # emitted spectrum IS this ix: the host never requantizes)
        sf21 = jnp.concatenate(
            [best_sf, jnp.zeros((R, 1), best_sf.dtype)], axis=1)
        amp_line = jnp.exp2(sf21[:, bol].astype(jnp.float32) / 2.0)
        ix = _quantize(jnp, p34_base * amp_line ** 0.75, sign, best_gg)
        ix = jnp.where(has_any[:, None], ix, 0)
        bits, selr, _bv, _k, c1sel = _count_rows(jnp, C, ix, switched)
        # wire dtypes: ship the narrowest exact types (hosts upcast on
        # arrival)
        return (best_gg.astype(jnp.uint8), best_sf.astype(jnp.uint8),
                has_any, ix.astype(jnp.int16), bits.astype(jnp.int16),
                selr.astype(jnp.int8), c1sel.astype(jnp.int8), done_end,
                iters.astype(jnp.uint8))

    @jax.jit
    def run(xr, xmin, budgets):
        n = xr.shape[0] // CHUNK
        xrc = xr.reshape(n, CHUNK, SPF)
        xmc = xmin.reshape(n, CHUNK, 21)
        bdc = budgets.reshape(n, CHUNK)
        gg, sf, has, ix, bits, selr, c1, conv, iters = \
            jax.lax.map(one_chunk, (xrc, xmc, bdc))
        return (gg.reshape(-1), sf.reshape(-1, 21), has.reshape(-1),
                ix.reshape(-1, SPF), bits.reshape(-1),
                selr.reshape(-1, 3), c1.reshape(-1), conv.reshape(-1),
                iters.reshape(-1))

    return run


@functools.lru_cache(maxsize=None)
def _jit_outer_short(sample_rate: int, max_iters: int, jump: bool = True):
    import jax
    import jax.numpy as jnp
    C = _device_consts(sample_rate)
    CHUNK, _MACRO = _dims()
    SF_CAP = jnp.asarray([15] * 6 + [7] * 6, jnp.int32)

    def one_chunk(args):
        xr, xmin, budget_bits = args
        p34_base = jnp.abs(xr) ** 0.75
        sign = jnp.sign(xr).astype(jnp.int32)
        R = xr.shape[0]
        wl, sl = C["wline"], C["sline"]

        def body_w(window):
            def body(_i, carry):
                (sf, sbg, gg_lo, done, best_gg, best_sf, best_sbg,
                 has_best, it) = carry
                it = it + (~done).astype(it.dtype)  # per-row active iters
                m1 = jnp.max(sf[:, :, :6], axis=(1, 2))
                m2 = jnp.max(sf[:, :, 6:12], axis=(1, 2))
                need1 = jnp.zeros_like(m1)
                need2 = jnp.zeros_like(m2)
                for kk in range(1, 5):
                    need1 = jnp.where(m1 >= (1 << (kk - 1)), kk, need1)
                    need2 = jnp.where(m2 >= (1 << (kk - 1)), kk, need2)
                ok = (C["slen1"][None] >= need1[:, None]) & \
                     (C["slen2"][None] >= need2[:, None])
                cost = 18 * (C["slen1"] + C["slen2"])
                sfc = jnp.argmin(jnp.where(ok, cost[None], 1 << 30), axis=1)
                sfbits = 18 * (C["slen1"][sfc] + C["slen2"][sfc])
                budget = budget_bits - sfbits
                done = done | (budget < 0)

                sf13 = jnp.concatenate(
                    [sf, jnp.zeros((R, 3, 1), sf.dtype)], axis=2)
                q = 8 * sbg[:, :, None] + 2 * sf13              # [R,3,13]
                amp = jnp.exp2(q[:, wl, sl].astype(jnp.float32) / 4.0)
                p34 = p34_base * amp ** 0.75
                gg, has, capped, next_lo = _inner_bisect(
                    jnp, C, p34, sign, budget, gg_lo, True, window)
                upd = ~done & has
                best_gg = jnp.where(upd, gg, best_gg)
                best_sf = jnp.where(upd[:, None, None], sf, best_sf)
                best_sbg = jnp.where(upd[:, None], sbg, best_sbg)
                has_best = has_best | upd
                gg_lo = jnp.where(~done,
                                  jnp.where(capped, next_lo, gg), gg_lo)

                ix = _quantize(jnp, p34, sign, gg)
                deq = (jnp.abs(ix).astype(jnp.float32) ** (4.0 / 3.0)) * \
                    jnp.exp2((gg[:, None].astype(jnp.float32) - 210.0)
                             / 4.0) / amp
                err = (jnp.abs(xr) - deq) ** 2
                dist = jnp.matmul(err, C["ind39"], precision=HIGHEST
                                  ).reshape(R, 3, 13)[:, :, :12]
                over = (dist > xmin) & \
                    ((sf < SF_CAP[None, None]) | (sbg[:, :, None] < 7)) & \
                    ~done[:, None, None] & has[:, None, None]
                # window-capped rows are not converged (see long body)
                done = done | ~(over.reshape(R, -1).any(1) | capped)
                if jump:
                    # at most one step past the slen cap per iteration:
                    # the overshoot escalates subblock_gain (see quantize)
                    ratio = jnp.clip(dist / jnp.maximum(xmin, 1e-37),
                                     1.0, 2.0 ** 60)
                    k = jnp.floor(0.5 * jnp.log2(ratio)).astype(sf.dtype)
                    k = jnp.clip(k, 1,
                                 jnp.maximum(SF_CAP[None, None] + 1 - sf,
                                             1))
                else:
                    k = jnp.ones((), sf.dtype)
                sf = sf + jnp.where(over, k, 0)
                exceed = (sf > SF_CAP[None, None]).any(2)       # [R,3]
                bump = exceed & (sbg < 7)
                sbg = sbg + bump.astype(sbg.dtype)
                sf = jnp.where(bump[:, :, None], jnp.maximum(sf - 4, 0), sf)
                sf = jnp.where(exceed[:, :, None],
                               jnp.minimum(sf, SF_CAP[None, None]), sf)
                return (sf, sbg, gg_lo, done, best_gg, best_sf, best_sbg,
                        has_best, it)
            return body

        sf0 = jnp.zeros((R, 3, 12), jnp.int32)
        sbg0 = jnp.zeros((R, 3), jnp.int32)
        init = (sf0, sbg0, jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), jnp.bool_), jnp.full((R,), 210, jnp.int32),
                sf0, sbg0, jnp.zeros((R,), jnp.bool_),
                jnp.zeros((R,), jnp.int32))
        # iteration 1 full-range, then GG_WINDOW bisection + early-exit
        # while_loop — see _jit_outer_long (bit-identical)
        carry1 = body_w(None)(0, init)
        _i, out = jax.lax.while_loop(
            lambda c: (c[0] < max_iters) & ~jnp.all(c[1][3]),
            lambda c: (c[0] + 1, body_w(GG_WINDOW)(c[0], c[1])),
            (jnp.int32(1), carry1))
        (_sf, _sbg, _gl, done_end, best_gg, best_sf, best_sbg, has_best,
         iters) = out
        gg_fb, has_fb, _c, _n = _inner_bisect(
            jnp, C, p34_base, sign, budget_bits,
            jnp.zeros((R,), jnp.int32), True)
        best_gg = jnp.where(has_best, best_gg, gg_fb)
        best_sf = jnp.where(has_best[:, None, None], best_sf, 0)
        best_sbg = jnp.where(has_best[:, None], best_sbg, 0)
        has_any = has_best | has_fb
        sf13 = jnp.concatenate(
            [best_sf, jnp.zeros((R, 3, 1), best_sf.dtype)], axis=2)
        q = 8 * best_sbg[:, :, None] + 2 * sf13
        amp = jnp.exp2(q[:, wl, sl].astype(jnp.float32) / 4.0)
        ix = _quantize(jnp, p34_base * amp ** 0.75, sign, best_gg)
        ix = jnp.where(has_any[:, None], ix, 0)
        bits, selr, _bv, _k, c1sel = _count_rows(jnp, C, ix, True)
        return (best_gg.astype(jnp.uint8), best_sf.astype(jnp.uint8),
                best_sbg.astype(jnp.uint8), has_any,
                ix.astype(jnp.int16), bits.astype(jnp.int16),
                selr.astype(jnp.int8), c1sel.astype(jnp.int8),
                done_end, iters.astype(jnp.uint8))

    @jax.jit
    def run(xr, xmin, budgets):
        n = xr.shape[0] // CHUNK
        gg, sf, sbg, has, ix, bits, selr, c1, conv, iters = jax.lax.map(
            one_chunk, (xr.reshape(n, CHUNK, SPF),
                        xmin.reshape(n, CHUNK, 3, 12),
                        budgets.reshape(n, CHUNK)))
        return (gg.reshape(-1), sf.reshape(-1, 3, 12),
                sbg.reshape(-1, 3), has.reshape(-1),
                ix.reshape(-1, SPF), bits.reshape(-1),
                selr.reshape(-1, 3), c1.reshape(-1), conv.reshape(-1),
                iters.reshape(-1))

    return run


@functools.lru_cache(maxsize=None)
def _jit_rate_only(sample_rate: int, short_split: bool):
    import jax
    import jax.numpy as jnp
    C = _device_consts(sample_rate)
    CHUNK, _MACRO = _dims()

    def one_chunk(args):
        xr, budgets = args
        p34 = jnp.abs(xr) ** 0.75
        sign = jnp.sign(xr).astype(jnp.int32)
        gg, has, _c, _n = _inner_bisect(jnp, C, p34, sign, budgets,
                                        jnp.zeros((xr.shape[0],),
                                                  jnp.int32),
                                        short_split)
        ix = _quantize(jnp, p34, sign, gg)
        ix = jnp.where(has[:, None], ix, 0)
        bits, selr, _bv, _k, c1sel = _count_rows(jnp, C, ix, short_split)
        return gg.astype(jnp.uint8), has, ix.astype(jnp.int16), \
            bits.astype(jnp.int16), selr.astype(jnp.int8), \
            c1sel.astype(jnp.int8)

    @jax.jit
    def run(xr, budgets):
        n = xr.shape[0] // CHUNK
        gg, has, ix, bits, selr, c1 = jax.lax.map(
            one_chunk, (xr.reshape(n, CHUNK, SPF),
                        budgets.reshape(n, CHUNK)))
        return (gg.reshape(-1), has.reshape(-1), ix.reshape(-1, SPF),
                bits.reshape(-1), selr.reshape(-1, 3), c1.reshape(-1))

    return run


def _pad(a, R):
    if a.shape[0] == R:
        return a
    pad = np.zeros((R - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _block_plan(n: int):
    """Block sizes covering n rows: full MACROs plus a tail from
    {MACRO, MACRO/2, MACRO/4} (each a CHUNK multiple, so the jits just
    re-specialize — at most 2 extra compiles per fn, cached
    persistently). Tail padding would otherwise dominate small
    categories' D2H: a 1.2k-row start/stop or short-block category
    padded to a full 8192 MACRO downloads 6.8x the bytes it needs."""
    CHUNK, MACRO = _dims()
    half, quarter = MACRO // 2, MACRO // 4
    out = []
    rem = max(n, 1)
    while rem >= MACRO:
        out.append(MACRO)
        rem -= MACRO
    if rem == 0:
        return out
    if quarter >= CHUNK and rem <= quarter:
        out.append(quarter)
    elif half >= CHUNK and rem <= half:
        out.append(half)
    elif quarter >= CHUNK and half >= CHUNK and rem <= half + quarter:
        out.extend([half, quarter])
    else:
        out.append(MACRO)
    return out


#: wall-clock split of the block runners, populated when
#: MP3TPU_ENCODE_PROFILE=1 (keys: dispatch_s, materialize_s, rows,
#: dl_bytes) — read by tools/ profiling probes.
PROF: dict = {}

# ---- wire packing of the emitted spectra ----------------------------
# ix int16[576] is ~83% of encode_batch's downloaded bytes
# (docs/encode_batch_notes.md). On the wire it ships
# as an int8 plane (values in [-127, 127] inline, -128 = escape) plus
# a <= _ESC_K-entry COO sideband (line positions + int16 values, in
# line order) — 642 B/row instead of 1152, bit-exact. |v| > 127 needs
# >= 192 kbps material; rows with more than _ESC_K escapes are flagged
# and their exact rows gathered from the device-resident raw ix (rare
# to nonexistent at supported bitrates).
_ESC_K = 16


@functools.lru_cache(maxsize=None)
def _jit_pack_ix():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def pack(ix):
        v = ix.astype(jnp.int32)
        big = jnp.abs(v) > 127
        plane = jnp.where(big, jnp.int32(-128), v).astype(jnp.int8)
        # escapes first (ascending line), then leading non-escape lines
        # as harmless identity fills — unpack assigns all K slots
        score = big.astype(jnp.int32) * 4096 + \
            (SPF - jax.lax.iota(jnp.int32, SPF))[None, :]
        _s, pos = jax.lax.top_k(score, _ESC_K)
        vals = jnp.take_along_axis(v, pos, axis=1).astype(jnp.int16)
        n_esc = jnp.sum(big, axis=1).astype(jnp.int16)
        return plane, pos.astype(jnp.int16), vals, n_esc

    return pack


def _unpack_ix_host(plane, pos, vals):
    """Wire plane + COO sideband -> ix int16 [R, 576]. Slots beyond a
    row's escape count carry non-escape lines whose value equals the
    plane's — assigning all slots unconditionally is identity there."""
    ix = plane.astype(np.int16)
    r = np.arange(ix.shape[0])[:, None]
    ix[r, pos.astype(np.int64)] = vals
    return ix


def _bucket_rows(cnt: int, size: int) -> int:
    """Rows to download for a block with cnt valid of size dispatched:
    tail padding rounds to 1024 (a handful of cached slice programs)
    instead of downloading the full MACRO pad."""
    return min(size, max(1024, -(-cnt // 1024) * 1024))


def _prof_add(key, v):
    import os
    if os.environ.get("MP3TPU_ENCODE_PROFILE") == "1":
        PROF[key] = PROF.get(key, 0) + v


def _materialize(blocks):
    """[(n_valid, device_outputs)] -> host tuples, one concat per output.
    Downloads were started async right after each dispatch, so device
    compute of later blocks overlaps earlier blocks' D2H. Deferred
    (_Pending) blocks arrive with only their light outputs copied —
    start every remaining copy NOW, before the first blocking
    np.asarray, or each output pays its download latency serially."""
    import time
    t0 = time.perf_counter()
    for _cnt, block in blocks:
        _async_copy(block)
    outs = [[] for _ in blocks[0][1]]
    nbytes = 0
    for cnt, block in blocks:
        for acc, o in zip(outs, block):
            h = np.asarray(o)
            nbytes += h.nbytes
            acc.append(h[:cnt])
    _prof_add("materialize_s", time.perf_counter() - t0)
    _prof_add("dl_bytes", nbytes)
    return tuple(np.concatenate(acc) for acc in outs)


def _async_copy(block, only=None):
    for i, o in enumerate(block):
        if only is not None and i not in only:
            continue
        try:
            o.copy_to_host_async()
        except Exception:
            pass


@functools.lru_cache(maxsize=None)
def _gather_fn(n_blocks: int, n_outs: int):
    """One-dispatch device gather over per-output block lists: concat
    the MACRO blocks and take the requested rows. Compiled per
    (block-count, output-count) structure; jax re-specializes per
    row-bucket size (buckets are powers of two, so the set is small)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def g(rows, *flat):
        outs = []
        for o in range(n_outs):
            parts = [flat[b * n_outs + o] for b in range(n_blocks)]
            cat = parts[0] if n_blocks == 1 else jnp.concatenate(parts)
            outs.append(jnp.take(cat, rows, axis=0))
        return tuple(outs)

    return g


class _Pending:
    """Deferred block results: device Arrays kept un-downloaded so the
    caller can decide LATER which outputs/rows to pay D2H for.
    Used by encode_batch's two-pass reservoir walk: pass A only needs
    per-row bit counts + scalefactors to plan upgrades, and ~99% of
    rows are re-quantized in pass B, so downloading pass-A spectra
    up front is almost entirely wasted bytes.

    With ix_idx set, the blocks hold the WIRE layout: the ix slot
    carries the int8 plane and (pos, vals, n_esc) ride appended at the
    end; _decode() reconstructs exact ix on host, patching the rare
    over-_ESC_K rows from the device-resident raw blocks."""

    def __init__(self, blocks, n, ix_idx=None, raw=None):
        self.blocks = blocks          # [(valid_count, tuple(Array))]
        self.n = n
        self.ix_idx = ix_idx
        self.raw = raw or []          # device ix blocks (overflow patch)

    def prefetch(self):
        """Start async D2H of every output now (non-blocking). Call
        before dispatching other device work so these bytes stream
        while that work computes."""
        for _cnt, blk in self.blocks:
            _async_copy(blk)

    def _patch_overflow(self, ix, nesc, global_rows):
        """Exact rows for >_ESC_K-escape rows, gathered from the raw
        device ix blocks (zero rows at supported bitrates — measured)."""
        over = np.nonzero(nesc > _ESC_K)[0]
        if not len(over):
            return ix
        import jax.numpy as jnp
        rows = np.asarray(global_rows, np.int64)[over]
        bucket = max(256, 1 << int(len(rows) - 1).bit_length())
        rp = np.zeros(bucket, np.int64)
        rp[: len(rows)] = rows
        out = _gather_fn(len(self.raw), 1)(jnp.asarray(rp), *self.raw)
        ix[over] = np.asarray(out[0])[: len(rows)]
        _prof_add("overflow_rows", len(rows))
        return ix

    def _decode(self, outs, global_rows):
        """Wire-layout host tuple -> the logical raw layout callers
        (post_long/post_short/post_rate) consume."""
        if self.ix_idx is None:
            return outs
        pos, vals, nesc = outs[-3], outs[-2], outs[-1]
        ix = _unpack_ix_host(outs[self.ix_idx], pos, vals)
        ix = self._patch_overflow(ix, nesc, global_rows)
        return outs[: self.ix_idx] + (ix,) + outs[self.ix_idx + 1: -3]

    def materialize_all(self):
        """Full logical outputs for every valid row (the eager path)."""
        full = _materialize(self.blocks)
        return self._decode(full, np.arange(self.n))

    def take(self, *out_idx):
        """Download ONLY the selected outputs (per-output Arrays are
        independent, so untouched outputs are never downloaded)."""
        import time
        assert self.ix_idx is None or self.ix_idx not in out_idx, \
            "take() cannot select the packed ix slot; use fetch_rows"
        t0 = time.perf_counter()
        for _cnt, blk in self.blocks:
            _async_copy(blk, only=set(out_idx))
        outs = []
        nbytes = 0
        for i in out_idx:
            parts = []
            for cnt, blk in self.blocks:
                h = np.asarray(blk[i])
                nbytes += h.nbytes
                parts.append(h[:cnt])
            outs.append(np.concatenate(parts))
        _prof_add("materialize_s", time.perf_counter() - t0)
        _prof_add("dl_bytes", nbytes)
        return tuple(outs)

    # raw-output slot indices per block kind (wire layout: plane at
    # ix_idx, (pos, vals, nesc) appended)
    _EMIT_IDX = {
        "long": dict(sf=1, selr=5, c1=6, gg=0, bits=4, sbg=None),
        "short": dict(sf=1, selr=6, c1=7, gg=0, bits=5, sbg=2),
        "rate": dict(sf=None, selr=4, c1=5, gg=0, bits=3, sbg=None),
    }

    def emit_and_take(self, kind, layout, sample_rate, use_sf, bits_cap):
        """Device-emit every block row (encoder/emit_device.py) and
        download the packed part2+part3 BYTES plus the side-info
        smalls — the spectra are never downloaded (they are ~83% of
        the encode path's D2H bytes; docs/encode_batch_notes.md).

        bits_cap: host-known per-local-row upper bound on part2_3 bits
        (pass-A p23 predictions / pass-B budgets) -> the downloaded
        word-slice width per block, stepped to bound executable count.

        Returns host arrays aligned with the pend's local rows:
        (bytes [n, <=520], meta [n, 5] (p23, bv, sfc, r0c, r1c),
        gg, tsel_cols, c1, hbits, sbg-or-None)."""
        import time
        import jax.numpy as jnp
        from . import emit_device
        IDX = self._EMIT_IDX[kind]
        t0 = time.perf_counter()
        per_block = []
        lo = 0
        for (cnt, blk), raw_ix in zip(self.blocks, self.raw):
            R = raw_ix.shape[0]
            if IDX["sf"] is not None and use_sf:
                sf = blk[IDX["sf"]]
            else:
                sf = jnp.zeros((R, 3, 12) if layout == "short" else (R, 21),
                               jnp.int32)
            words, meta = emit_device.emit_rows_device(
                raw_ix, sf, blk[IDX["selr"]], blk[IDX["c1"]],
                sample_rate, layout, use_sf)
            cap = int(bits_cap[lo: lo + cnt].max(initial=0))
            W0 = min(emit_device.CAP_WORDS, max(cap + 31, 31) // 32 + 1)
            W0 = min(-(-W0 // 32) * 32, emit_device.CAP_WORDS)  # 4 shapes
            outs = [words[:, :W0], meta, blk[IDX["gg"]],
                    blk[IDX["selr"]], blk[IDX["c1"]], blk[IDX["bits"]]]
            if IDX["sbg"] is not None:
                outs.append(blk[IDX["sbg"]])
            _async_copy(outs)
            per_block.append((cnt, outs))
            lo += cnt
        _prof_add("emit_dispatch_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        cols = []
        nbytes = 0
        n_outs = len(per_block[0][1])
        for o in range(n_outs):
            parts = []
            for cnt, outs in per_block:
                h = np.asarray(outs[o])
                nbytes += h.nbytes
                if o == 0:  # words -> byte rows, zero-padded to align
                    h = emit_device.words_to_bytes(h)
                parts.append(h[:cnt])
            w = max(p.shape[1] for p in parts) if parts[0].ndim > 1 else None
            if o == 0 and w is not None:
                parts = [np.pad(p, ((0, 0), (0, w - p.shape[1])))
                         for p in parts]
            cols.append(np.concatenate(parts))
        _prof_add("materialize_s", time.perf_counter() - t0)
        _prof_add("dl_bytes", nbytes)
        sbg = cols[6] if len(cols) > 6 else None
        return (cols[0], cols[1], cols[2], cols[3], cols[4], cols[5], sbg)

    def fetch_rows(self, rows):
        """Full logical outputs for the given local row positions.
        Small row sets ride a one-dispatch device gather (padded to a
        power-of-two bucket); large ones just materialize the blocks."""
        import time
        rows = np.asarray(rows, np.int64)
        total = sum(cnt for cnt, _ in self.blocks)
        if len(rows) > total // 4:
            full = _materialize(self.blocks)
            return self._decode(tuple(o[rows] for o in full), rows)
        import jax.numpy as jnp
        t0 = time.perf_counter()
        n_outs = len(self.blocks[0][1])
        bucket = max(256, 1 << int(len(rows) - 1).bit_length())
        rp = np.zeros(bucket, np.int64)
        rp[: len(rows)] = rows
        flat = [a for _, blk in self.blocks for a in blk]
        out = _gather_fn(len(self.blocks), n_outs)(jnp.asarray(rp), *flat)
        _async_copy(out)
        _prof_add("dispatch_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        hs = []
        nbytes = 0
        for o in out:
            h = np.asarray(o)
            nbytes += h.nbytes
            hs.append(h[: len(rows)])
        _prof_add("materialize_s", time.perf_counter() - t0)
        _prof_add("dl_bytes", nbytes)
        return self._decode(tuple(hs), rows)


def _run_padded(fn, n_rows, *arrays):
    """Dispatch in fixed MACRO-row blocks (stable compiled shapes)."""
    import time
    import jax.numpy as jnp
    blocks = []
    t0 = time.perf_counter()
    lo = 0
    for size in _block_plan(n_rows):
        hi = min(lo + size, n_rows)
        args = [jnp.asarray(_pad(np.ascontiguousarray(a[lo:hi]), size))
                for a in arrays]
        block = fn(*args)
        _async_copy(block)
        blocks.append((hi - lo, block))
        lo += size
    _prof_add("dispatch_s", time.perf_counter() - t0)
    _prof_add("rows", n_rows)
    return _materialize(blocks)


_TID = np.asarray(TABLE_IDS)


def _run_gathered(fn, xr_dev, xmin_dev, idx, budgets, defer=False,
                  ix_idx=None):
    """Run MACRO blocks gathering rows from DEVICE-resident tensors
    (no host round-trip of the spectra): idx/budgets are small host
    arrays; xr_dev [N,576] f32 and optional xmin_dev [N,...] f32 live
    on device (SURVEY.md §3.4 — one host/device boundary per batch).

    defer=True returns a _Pending instead of downloading: no D2H is
    started, so the caller can pay only for the outputs/rows it needs.

    ix_idx marks the emitted-spectrum output: it ships packed (int8
    plane + COO escape sideband, ~1.8x fewer bytes) with the raw ix
    kept device-resident for the rare overflow rows; tail blocks are
    additionally sliced to 1024-row buckets on device so MACRO padding
    is never downloaded."""
    import time
    import jax.numpy as jnp
    blocks = []
    raw = []
    n = len(idx)
    t0 = time.perf_counter()
    lo = 0
    for size in _block_plan(n):
        hi = min(lo + size, n)
        sel = np.zeros(size, np.int64)
        sel[: hi - lo] = idx[lo:hi]
        sel_j = jnp.asarray(sel)
        args = [jnp.take(xr_dev, sel_j, axis=0)]
        if xmin_dev is not None:
            args.append(jnp.take(xmin_dev, sel_j, axis=0))
        bud = np.zeros(size, np.int32)
        bud[: hi - lo] = budgets[lo:hi]
        args.append(jnp.asarray(bud))
        block = fn(*args)
        b = _bucket_rows(hi - lo, size)
        if ix_idx is not None:
            plane, pos, vals, nesc = _jit_pack_ix()(block[ix_idx])
            raw.append(block[ix_idx] if b == size else block[ix_idx][:b])
            block = block[: ix_idx] + (plane,) + block[ix_idx + 1:] \
                + (pos, vals, nesc)
        if b < size:
            block = tuple(o[:b] for o in block)
        if not defer:
            _async_copy(block)
        blocks.append((hi - lo, block))
        lo += size
    _prof_add("dispatch_s", time.perf_counter() - t0)
    _prof_add("rows", n)
    pend = _Pending(blocks, n, ix_idx=ix_idx, raw=raw)
    if defer:
        return pend
    return pend.materialize_all()


ITER_STATS: dict = {}   # kind -> np.int64[max_iters+1] bincount of the
#                         per-row outer-loop iteration counts (rate-loop
#                         telemetry, docs/rate_loop_notes.md); populated
#                         by post_long/post_short when MP3TPU_ITER_HIST=1


def _iter_stats_add(kind, iters):
    import os
    if not os.environ.get("MP3TPU_ITER_HIST"):
        return
    h = np.bincount(np.asarray(iters, np.int64))
    cur = ITER_STATS.get(kind)
    if cur is None or len(cur) < len(h):
        new = np.zeros(max(len(h), 0 if cur is None else len(cur)), np.int64)
        if cur is not None:
            new[: len(cur)] += cur
        cur = new
    cur[: len(h)] += h
    ITER_STATS[kind] = cur



def _jump() -> bool:
    from .quantize import sf_jump_default
    return sf_jump_default()

def take_iter_stats(pend, kind, label=None):
    """Fold a deferred block set's per-row outer-iteration counters into
    ITER_STATS (1 byte/row D2H; no-op unless MP3TPU_ITER_HIST=1). Used
    by the device-emit path, which never routes through post_long/short.
    Wire slot: iters sits after conv, before the pack sideband."""
    import os
    if not os.environ.get("MP3TPU_ITER_HIST"):
        return
    idx = {"long": 8, "short": 9}.get(kind)
    if idx is None:
        return
    (it,) = pend.take(idx)
    _iter_stats_add(label or kind, it)


def post_long(raw, label="long"):
    """Raw long-jit outputs -> the public tuple (shared by the eager
    wrappers and _Pending.fetch_rows so post-processing cannot drift)."""
    gg, sf, has, ix, bits, selr, c1, _conv, _it = raw
    _iter_stats_add(label, _it)
    return gg, sf, has, ix, bits.astype(np.int64), \
        _TID[selr.astype(np.int64)], c1.astype(np.int64)


def post_short(raw, label="short"):
    gg, sf, sbg, has, ix, bits, selr, c1, _conv, _it = raw
    _iter_stats_add(label, _it)
    return gg, sf, sbg, has, ix, bits.astype(np.int64), \
        _TID[selr.astype(np.int64)], c1.astype(np.int64)


def post_rate(raw):
    gg, has, ix, bits, selr, c1 = raw
    return gg, has, ix, bits.astype(np.int64), \
        _TID[selr.astype(np.int64)], c1.astype(np.int64)


def outer_rows_gathered(xr_dev, xmin_dev, idx, budgets, sample_rate,
                        max_iters=16, block_type=0):
    """One full-depth outer-loop pass for all rows. (An earlier
    two-phase convergence compaction — 4 iters for everyone, full
    replay for the unconverged tail — was retired: on shaped music
    content <1% of rows converge in 4 iters, so the short pass only
    added a second full set of dispatches and ~28 MB of discarded ix
    downloads.) block_type 1/3 selects the
    window-switched region split for the bit counter (start/stop
    shaping)."""
    fn = _jit_outer_long(sample_rate, max_iters, bool(block_type),
                         jump=_jump())
    return post_long(_run_gathered(fn, xr_dev, xmin_dev, idx, budgets,
                                   ix_idx=3),
                     label="switched" if block_type else "long")


def outer_rows_short_gathered(xr_dev, xmin_dev, idx, budgets, sample_rate,
                              max_iters=12):
    fn = _jit_outer_short(sample_rate, max_iters, jump=_jump())
    return post_short(_run_gathered(fn, xr_dev, xmin_dev, idx, budgets,
                                    ix_idx=4))


def rate_rows_gathered(xr_dev, idx, budgets, sample_rate, block_type):
    fn = _jit_rate_only(sample_rate, bool(block_type))
    return post_rate(_run_gathered(fn, xr_dev, None, idx, budgets,
                                   ix_idx=2))


# Deferred variants: dispatch the same jits but download ONLY the light
# planning outputs (scalefactors + exact bit counts — what the pass-B
# reservoir walk consumes); the full spectra stay on device inside the
# returned _Pending until the caller knows which rows survive pass B.
# Raw output layouts: long (gg, sf, has, ix, bits, selr, c1, conv, iters),
# short (gg, sf, sbg, has, ix, bits, selr, c1, conv, iters),
# rate (gg, has, ix, bits, selr, c1).

def outer_rows_gathered_light(xr_dev, xmin_dev, idx, budgets, sample_rate,
                              max_iters=16, block_type=0):
    fn = _jit_outer_long(sample_rate, max_iters, bool(block_type),
                         jump=_jump())
    pend = _run_gathered(fn, xr_dev, xmin_dev, idx, budgets, defer=True,
                         ix_idx=3)
    sf, bits = pend.take(1, 4)
    return (sf, bits.astype(np.int64)), pend


def outer_rows_short_gathered_light(xr_dev, xmin_dev, idx, budgets,
                                    sample_rate, max_iters=12):
    fn = _jit_outer_short(sample_rate, max_iters, jump=_jump())
    pend = _run_gathered(fn, xr_dev, xmin_dev, idx, budgets, defer=True,
                         ix_idx=4)
    sf, bits = pend.take(1, 5)
    return (sf, bits.astype(np.int64)), pend


def rate_rows_gathered_light(xr_dev, idx, budgets, sample_rate, block_type):
    fn = _jit_rate_only(sample_rate, bool(block_type))
    pend = _run_gathered(fn, xr_dev, None, idx, budgets, defer=True,
                         ix_idx=2)
    (bits,) = pend.take(3)
    return (bits.astype(np.int64),), pend


# Pending-only variants: dispatch and return the _Pending with ZERO
# downloads started — the caller overlaps other transfers with the
# device compute, then fetch_rows/finalize when it needs the results.

def outer_rows_gathered_pending(xr_dev, xmin_dev, idx, budgets,
                                sample_rate, max_iters=16, block_type=0):
    fn = _jit_outer_long(sample_rate, max_iters, bool(block_type),
                         jump=_jump())
    return _run_gathered(fn, xr_dev, xmin_dev, idx, budgets, defer=True,
                         ix_idx=3)


def outer_rows_short_gathered_pending(xr_dev, xmin_dev, idx, budgets,
                                      sample_rate, max_iters=12):
    fn = _jit_outer_short(sample_rate, max_iters, jump=_jump())
    return _run_gathered(fn, xr_dev, xmin_dev, idx, budgets, defer=True,
                         ix_idx=4)


def rate_rows_gathered_pending(xr_dev, idx, budgets, sample_rate,
                               block_type):
    fn = _jit_rate_only(sample_rate, bool(block_type))
    return _run_gathered(fn, xr_dev, None, idx, budgets, defer=True,
                         ix_idx=2)


def outer_rows_device(xr, xmin, budget_bits, sample_rate, max_iters=16):
    """Device outer loop (long blocks).

    Returns (gg, sf [R,21], has_best, ix [R,576] i16 — the spectrum to
    EMIT — bits [R] exact huffman+sign bits, tsel [R,3] table ids,
    c1table [R])."""
    fn = _jit_outer_long(sample_rate, max_iters, jump=_jump())
    gg, sf, has, ix, bits, selr, c1, _conv, _it = _run_padded(
        fn, len(xr), xr.astype(np.float32), xmin.astype(np.float32),
        budget_bits.astype(np.int32))
    _iter_stats_add("long", _it)
    return gg, sf, has, ix, bits.astype(np.int64), \
        _TID[selr.astype(np.int64)], c1.astype(np.int64)


def outer_rows_short_device(xr, xmin, budget_bits, sample_rate,
                            max_iters=12):
    """As outer_rows_device for short (window-switched) blocks; adds
    sbg [R,3]."""
    fn = _jit_outer_short(sample_rate, max_iters, jump=_jump())
    gg, sf, sbg, has, ix, bits, selr, c1, _conv, _it = _run_padded(
        fn, len(xr), xr.astype(np.float32), xmin.astype(np.float32),
        budget_bits.astype(np.int32))
    _iter_stats_add("short", _it)
    return gg, sf, sbg, has, ix, bits.astype(np.int64), \
        _TID[selr.astype(np.int64)], c1.astype(np.int64)


def rate_rows_device(xr, budget_bits, sample_rate, block_type):
    """Rate-only device bisection (no shaping / window-switched rows)."""
    fn = _jit_rate_only(sample_rate, bool(block_type))
    gg, has, ix, bits, selr, c1 = _run_padded(
        fn, len(xr), xr.astype(np.float32), budget_bits.astype(np.int32))
    return gg, has, ix, bits.astype(np.int64), \
        _TID[selr.astype(np.int64)], c1.astype(np.int64)


# ---------------------------------------------------------------- host
# exact finalization: f64 requantize at device-found parameters + exact
# recount, bumping gg on rows the f32 search left over budget.

def _host_quantize(xr_amp, gg):
    from .vloop import quantize_rows
    p34 = np.abs(xr_amp) ** 0.75
    return quantize_rows(p34, np.sign(xr_amp), gg.astype(np.int64))


def finalize_rows(xr, gg, amp, budget_net, sample_rate, block_type):
    """Host-exact ix for device-found (gg, amplification), with a
    safety bump loop: any row whose EXACT count exceeds its net budget
    (f32 boundary flips; rare) steps gg up until it fits. Returns
    (ix [R,576] i32, gg [R] i64)."""
    from .vcount import count_bits_rows
    gg = gg.astype(np.int64).copy()
    xr_amp = xr * amp
    ix = _host_quantize(xr_amp, gg)
    over_ix = np.abs(ix).max(1) > IX_MAX
    bits = count_bits_rows(ix, sample_rate, block_type)
    over = over_ix | (bits > budget_net)
    guard = 0
    while over.any() and guard < 64:
        bump = over & (gg < 255)
        dead = over & ~bump
        if dead.any():
            ix[dead] = 0
            gg[dead] = 210
            over[dead] = False
        if not bump.any():
            break
        gg[bump] += 1
        ix[bump] = _host_quantize(xr_amp[bump], gg[bump])
        bits_b = count_bits_rows(ix[bump], sample_rate, block_type)
        still = (np.abs(ix[bump]).max(1) > IX_MAX) | (bits_b > budget_net[bump])
        nxt = np.zeros_like(over)
        nxt[np.nonzero(bump)[0]] = still
        over = nxt
        guard += 1
    return ix, gg
