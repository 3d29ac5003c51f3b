"""Device Huffman EMISSION (SURVEY.md E5 on the accelerator).

The encode path's dominant D2H cost is shipping the emitted spectra
(`ix`, ~83% of downloaded bytes) to the host emitter. This module
produces the packed part2+part3 bitstream ON DEVICE instead — the
host then downloads ~the coded bytes (an entropy-sized payload)
rather than the spectra, and the native row emitter is bypassed.

Formulation (all fixed-shape, one jit per (layout, sample_rate,
use_sf)):
  - the big-values/count1/rzero split, region ids and table columns
    reuse the exact vloop_device._count_rows formulas (count == emit
    is the reservoir contract; this emitter must land on the counted
    bit budget row-for-row);
  - per-symbol (value, length) fields are table gathers + elementwise
    math: 36 scalefactor slots, 288 pairs x 5 fields (code, linbits-x,
    sign-x, linbits-y, sign-y), 144 quads x 5 fields (code, 4 signs)
    -> [R, 2196] field vectors in exact emission order;
  - MSB-first bit packing is ONE one-hot matmul with a 16-bit hi/lo
    split (sums of disjoint-bit contributions are < 2^16 per half, so
    f32 accumulation is exact — provided the product runs at HIGHEST
    precision: TF32 operands keep 11 significant bits and would
    corrupt the 16-bit halves).

Byte-identical to huffcode.encode_granule / the native C++ emitter
(tested row-for-row in test_emit_device.py)."""
from __future__ import annotations

import functools

import numpy as np

from ..tables import huffman as ht
from ..tables.sfb import LONG
from .huffcode import _regions_long
from .vcount import N_PLAIN, TABLE_IDS
from .vloop import _SLEN1, _SLEN2

SPF = 576
FIELDS = 36 + 288 * 5 + 144 * 5          # sf + pairs + quads
# 4095-bit part2_3 max = 128 words + 1 spill; 130 words == the native
# emitter's 520-byte row cap, so device byte rows drop straight in
CAP_WORDS = 130


@functools.lru_cache(maxsize=None)
def _emit_consts(sample_rate: int):
    import jax.numpy as jnp
    T = len(TABLE_IDS)
    lut = np.zeros((T, 16, 16), np.int32)     # (len << 19) | code
    linbits = np.zeros(T, np.int32)
    esc16 = np.zeros(T, np.bool_)             # xl == 16: host esc branch
    for col, tid in enumerate(TABLE_IDS):
        if tid == 0:
            continue
        lens, codes, xl, yl, lb = ht.table_arrays(tid)
        ll = np.asarray(lens).reshape(xl, yl)
        cc = np.asarray(codes).reshape(xl, yl)
        lut[col, :xl, :yl] = (ll.astype(np.int32) << 19) | cc.astype(np.int32)
        esc16[col] = xl == 16
        linbits[col] = lb if esc16[col] else 0
    c1a = ((np.asarray(ht.COUNT1A_LENS, np.int32) << 19)
           | np.asarray(ht.COUNT1A_CODES, np.int32))
    # long-layout region tables per big_values (pairs): r1/r2 pair
    # boundaries + the r0c/r1c side-info counts, exact _regions_long
    r1p = np.zeros(289, np.int32)
    r2p = np.zeros(289, np.int32)
    r0c_t = np.zeros(289, np.int32)
    r1c_t = np.zeros(289, np.int32)
    for bv in range(289):
        r0c, r1c, r1, r2 = _regions_long(2 * bv, sample_rate)
        r1p[bv], r2p[bv] = r1 // 2, r2 // 2
        r0c_t[bv], r1c_t[bv] = r0c, r1c
    fixed_pairs = int(LONG[sample_rate][8]) // 2   # == 18 for MPEG-1 rates
    f = lambda a, dt: jnp.asarray(a, dt)
    return dict(
        lut=f(lut.reshape(-1), jnp.int32), c1a=f(c1a, jnp.int32),
        linbits=f(linbits, jnp.int32), esc16=f(esc16, jnp.bool_),
        r1p=f(r1p, jnp.int32), r2p=f(r2p, jnp.int32),
        r0c_t=f(r0c_t, jnp.int32), r1c_t=f(r1c_t, jnp.int32),
        slen1=f(np.asarray(_SLEN1), jnp.int32),
        slen2=f(np.asarray(_SLEN2), jnp.int32),
        fixed_pairs=fixed_pairs,
    )


def _bitlen4(jnp, v):
    """bit_length of v in [0, 15] via a comparison ladder."""
    return ((v > 0).astype(jnp.int32) + (v > 1) + (v > 3) + (v > 7))


def _pack_words(jnp, V, L, W):
    """MSB-first pack: fields (V, L) [R, F] -> u32 words [R, W].
    Disjoint bits make add == or; the 16-bit split keeps f32 sums
    exact (HIGHEST precision: no TF32 rounding of the halves)."""
    off = jnp.cumsum(L, axis=1) - L
    w = (off >> 5).astype(jnp.int32)
    r = off & 31
    sh = (32 - r - L).astype(jnp.int32)
    v = V.astype(jnp.uint32)
    # both where-branches evaluate: clamp shift amounts into [0, 31]
    hi = jnp.where(sh >= 0, v << jnp.clip(sh, 0, 31),
                   v >> jnp.clip(-sh, 0, 31)).astype(jnp.uint32)
    lo = jnp.where(sh >= 0, jnp.uint32(0),
                   v << jnp.clip(32 + sh, 0, 31)).astype(jnp.uint32)
    dead = L == 0
    hi = jnp.where(dead, jnp.uint32(0), hi)
    lo = jnp.where(dead, jnp.uint32(0), lo)
    cols = jnp.arange(W, dtype=jnp.int32)
    oh = (w[:, :, None] == cols[None, None]).astype(jnp.float32)
    oh2 = (w[:, :, None] + 1 == cols[None, None]).astype(jnp.float32)

    def mm(c, o):
        a = jnp.einsum("rf,rfw->rw", (c >> 16).astype(jnp.float32), o,
                       precision="highest")
        b = jnp.einsum("rf,rfw->rw", (c & 0xFFFF).astype(jnp.float32), o,
                       precision="highest")
        return (a.astype(jnp.uint32) << 16) + b.astype(jnp.uint32)

    return mm(hi, oh) + mm(lo, oh2)


@functools.lru_cache(maxsize=None)
def _jit_emit(sample_rate: int, layout: str, use_sf: bool, W: int):
    """layout: "long" (block type 0), "switched" (1/3: long spectrum,
    fixed 2-region split, long sf), "short" (2: fixed split, short sf).
    Returns (words u32 [R, W], nbits i32, bv, sfc, r0c, r1c)."""
    import jax
    import jax.numpy as jnp
    C = _emit_consts(sample_rate)
    switched = layout != "long"
    short = layout == "short"

    @jax.jit
    def emit(ix, sf, selr, c1sel):
        ix = ix.astype(jnp.int32)
        R = ix.shape[0]
        a = jnp.abs(ix[:, 0::2])
        b = jnp.abs(ix[:, 1::2])
        nz = (a | b) > 0
        big = jnp.maximum(a, b) > 1
        anynz = nz.any(1)
        rzp = jnp.where(anynz, 288 - jnp.argmax(nz[:, ::-1], axis=1), 0)
        rzp = rzp + (rzp & 1)
        anybig = big.any(1)
        bigp = jnp.where(anybig, 288 - jnp.argmax(big[:, ::-1], axis=1), 0)
        k = (rzp - bigp) // 2
        bv = rzp - 2 * k                     # big-values region in pairs
        if switched:
            r1 = jnp.minimum(C["fixed_pairs"], bv)
            r2 = bv
            r0c = jnp.full((R,), 8 if short else 7, jnp.int32)
            r1c = jnp.full((R,), 20 - (8 if short else 7), jnp.int32)
        else:
            r1 = C["r1p"][bv]
            r2 = C["r2p"][bv]
            r0c = C["r0c_t"][bv]
            r1c = C["r1c_t"][bv]

        pidx = jnp.arange(288, dtype=jnp.int32)
        rid = ((pidx[None] >= r1[:, None]).astype(jnp.int32)
               + (pidx[None] >= r2[:, None]))
        active = pidx[None] < bv[:, None]
        tcol = jnp.take_along_axis(selr.astype(jnp.int32),
                                   jnp.minimum(rid, 2), axis=1)  # [R, 288]
        cx = jnp.minimum(a, 15)
        cy = jnp.minimum(b, 15)
        entry = jnp.take(C["lut"], tcol * 256 + cx * 16 + cy)
        esc = jnp.take(C["esc16"], tcol)
        lb = jnp.take(C["linbits"], tcol)
        Vp = jnp.zeros((R, 288, 5), jnp.int32)
        Lp = jnp.zeros((R, 288, 5), jnp.int32)
        act = active.astype(jnp.int32)
        Vp = Vp.at[:, :, 0].set(entry & ((1 << 19) - 1))
        Lp = Lp.at[:, :, 0].set((entry >> 19) * act)
        esc_a = active & esc & (a >= 15)
        esc_b = active & esc & (b >= 15)
        Vp = Vp.at[:, :, 1].set(jnp.maximum(a - 15, 0))
        Lp = Lp.at[:, :, 1].set(jnp.where(esc_a, lb, 0))
        Vp = Vp.at[:, :, 2].set((ix[:, 0::2] < 0).astype(jnp.int32))
        Lp = Lp.at[:, :, 2].set((active & (a > 0)).astype(jnp.int32))
        Vp = Vp.at[:, :, 3].set(jnp.maximum(b - 15, 0))
        Lp = Lp.at[:, :, 3].set(jnp.where(esc_b, lb, 0))
        Vp = Vp.at[:, :, 4].set((ix[:, 1::2] < 0).astype(jnp.int32))
        Lp = Lp.at[:, :, 4].set((active & (b > 0)).astype(jnp.int32))

        # count1 quads: k on the quad grid after bv pairs
        q = ix.reshape(R, 144, 4)
        aq = jnp.abs(q)
        qi = jnp.arange(144, dtype=jnp.int32)
        q0 = bv // 2
        qact = (qi[None] >= q0[:, None]) & (qi[None] < (q0 + k)[:, None])
        idxq = ((aq[..., 0] << 3) | (aq[..., 1] << 2)
                | (aq[..., 2] << 1) | aq[..., 3]).astype(jnp.int32)
        idxq = jnp.minimum(idxq, 15)         # inactive quads may exceed
        ea = jnp.take(C["c1a"], idxq)
        useB = (c1sel.astype(jnp.int32) != 0)[:, None]
        qcode = jnp.where(useB, 15 - idxq, ea & ((1 << 19) - 1))
        qlen = jnp.where(useB, 4, ea >> 19)
        Vq = jnp.zeros((R, 144, 5), jnp.int32)
        Lq = jnp.zeros((R, 144, 5), jnp.int32)
        qa = qact.astype(jnp.int32)
        Vq = Vq.at[:, :, 0].set(qcode)
        Lq = Lq.at[:, :, 0].set(qlen * qa)
        for j in range(4):
            Vq = Vq.at[:, :, 1 + j].set((q[..., j] < 0).astype(jnp.int32))
            Lq = Lq.at[:, :, 1 + j].set(
                (qact & (aq[..., j] > 0)).astype(jnp.int32))

        # scalefactors (part2) — 36 slots, layout-dependent lengths
        Vs = jnp.zeros((R, 36), jnp.int32)
        Ls = jnp.zeros((R, 36), jnp.int32)
        sfc = jnp.zeros((R,), jnp.int32)
        if use_sf:
            sfi = sf.astype(jnp.int32)
            s1c = C["slen1"]
            s2c = C["slen2"]
            if short:
                # sf [R, 3, 12] window-major -> emission is sfb-major,
                # window-minor; slen1 covers sfb 0-5, slen2 sfb 6-11
                need1 = _bitlen4(jnp, jnp.max(sfi[:, :, :6], axis=(1, 2)))
                need2 = _bitlen4(jnp, jnp.max(sfi[:, :, 6:12], axis=(1, 2)))
                cost = 18 * (s1c + s2c)[None, :]
                fit = ((s1c[None] >= need1[:, None])
                       & (s2c[None] >= need2[:, None]))
                sfc = jnp.argmin(jnp.where(fit, cost, 1 << 30),
                                 axis=1).astype(jnp.int32)
                vs = sfi.transpose(0, 2, 1).reshape(R, 36)
                s1 = s1c[sfc][:, None]
                s2 = s2c[sfc][:, None]
                ls = jnp.concatenate(
                    [jnp.broadcast_to(s1, (R, 18)),
                     jnp.broadcast_to(s2, (R, 18))], axis=1)
                emit_any = sfi.reshape(R, -1).any(1)
            else:
                # long: 11 bands at slen1, 10 at slen2, 15 dead slots
                need1 = _bitlen4(jnp, jnp.max(sfi[:, :11], axis=1))
                need2 = _bitlen4(jnp, jnp.max(sfi[:, 11:21], axis=1))
                cost = (11 * s1c + 10 * s2c)[None, :]
                fit = ((s1c[None] >= need1[:, None])
                       & (s2c[None] >= need2[:, None]))
                sfc = jnp.argmin(jnp.where(fit, cost, 1 << 30),
                                 axis=1).astype(jnp.int32)
                vs = jnp.concatenate(
                    [sfi[:, :21], jnp.zeros((R, 15), jnp.int32)], axis=1)
                s1 = s1c[sfc][:, None]
                s2 = s2c[sfc][:, None]
                ls = jnp.concatenate(
                    [jnp.broadcast_to(s1, (R, 11)),
                     jnp.broadcast_to(s2, (R, 10)),
                     jnp.zeros((R, 15), jnp.int32)], axis=1)
                emit_any = sfi[:, :21].any(1)
            m = emit_any[:, None].astype(jnp.int32)
            Vs, Ls = vs * m, ls * m
            sfc = sfc * emit_any.astype(jnp.int32)

        V = jnp.concatenate(
            [Vs, Vp.reshape(R, -1), Vq.reshape(R, -1)], axis=1)
        L = jnp.concatenate(
            [Ls, Lp.reshape(R, -1), Lq.reshape(R, -1)], axis=1)
        nbits = jnp.sum(L, axis=1).astype(jnp.int32)
        words = _pack_words(jnp, V, L, W)
        meta = jnp.stack([nbits, bv.astype(jnp.int32), sfc, r0c, r1c],
                         axis=1)              # one small D2H per block
        return words, meta

    return emit


def emit_rows_device(ix, sf, tsel_cols, c1sel, sample_rate: int,
                     layout: str, use_sf: bool, W: int = CAP_WORDS):
    """Emit rows on device from device (or host) arrays; returns device
    arrays (words u32 [R, W] MSB-first big-endian word stream,
    meta i32 [R, 5] = (part2_3_length, big_values, scalefac_compress,
    region0_count, region1_count)). tsel_cols are TABLE_IDS COLUMN
    indices (the loop kernels' selr output), not raw table ids."""
    return _jit_emit(sample_rate, layout, bool(use_sf), W)(
        ix, sf, tsel_cols, c1sel)


def words_to_bytes(words: np.ndarray) -> np.ndarray:
    """u32 MSB-first words [R, W] -> the emitter's byte rows [R, W*4]."""
    return np.ascontiguousarray(words).astype(">u4").view(np.uint8).reshape(
        words.shape[0], -1)
