"""Device Huffman emission (encoder/emit_device.py) parity: the packed
part2+part3 bitstream must be byte-identical to huffcode.encode_granule
(and therefore to the native C++ emitter, which is pinned elsewhere)
for every layout, escape pattern, and scalefactor mode — this is the
count == emit contract extended onto the device."""
import numpy as np
import pytest

from mp3tpu.encoder.emit_device import (CAP_WORDS, emit_rows_device,
                                        words_to_bytes)
from mp3tpu.encoder.huffcode import encode_granule
from mp3tpu.encoder.vcount import TABLE_IDS

SR = 44100
COL_OF = {tid: col for col, tid in enumerate(TABLE_IDS)}


def _rand_rows(rng, n, scale=30, sparsity=0.5, tail=None):
    """Spectra shaped like rate-loop output: decaying magnitudes, a
    quad-aligned count1 stretch, an rzero tail."""
    rows = np.zeros((n, 576), np.int32)
    for i in range(n):
        live = tail if tail is not None else int(rng.integers(8, 560))
        mag = (rng.standard_normal(live)
               * scale * np.exp(-3.0 * np.arange(live) / max(live, 1)))
        rows[i, :live] = np.rint(mag).astype(np.int32)
        c1 = int(rng.integers(0, 60)) * 4
        lo = max(live - c1, 0)
        rows[i, lo:live] = rng.integers(-1, 2, live - lo)
    return rows


def _emit_host(ix, bt, long_sf=None, short_sf=None):
    kw = {}
    if long_sf is not None and long_sf.any():
        kw["long_sf"] = long_sf
    if short_sf is not None and short_sf.any():
        kw["short_sf"] = short_sf
    g = encode_granule(np.asarray(ix, np.int32), 210, SR, bt, **kw)
    row = np.packbits(np.asarray(g.bits.bits, np.uint8))
    out = np.zeros(CAP_WORDS * 4, np.uint8)
    out[: len(row)] = row
    return out, g


def _check_layout(rows, bt, layout, use_sf, lsf=None, ssf=None):
    n = len(rows)
    refs, gs = [], []
    for i in range(n):
        ref, g = _emit_host(rows[i], bt,
                            long_sf=None if lsf is None else lsf[i],
                            short_sf=None if ssf is None else ssf[i])
        refs.append(ref)
        gs.append(g)
    tsel = np.array([[COL_OF[t] for t in g.table_select] for g in gs],
                    np.int32)
    c1 = np.array([g.count1table_select for g in gs], np.int32)
    if layout == "short":
        sf = (np.zeros((n, 3, 12), np.int32) if ssf is None
              else ssf.astype(np.int32))
    else:
        sf = (np.zeros((n, 21), np.int32) if lsf is None
              else lsf.astype(np.int32))
    words, meta = emit_rows_device(rows, sf, tsel, c1, SR, layout, use_sf)
    meta = np.asarray(meta)
    got = words_to_bytes(np.asarray(words))
    for i in range(n):
        assert int(meta[i, 0]) == gs[i].part2_3_length, i
        assert np.array_equal(got[i], refs[i]), i
        assert int(meta[i, 1]) == gs[i].big_values, i
        assert int(meta[i, 2]) == gs[i].scalefac_compress, i
        assert int(meta[i, 3]) == gs[i].region0_count, i
        assert int(meta[i, 4]) == gs[i].region1_count, i


def test_long_plain():
    rng = np.random.default_rng(0)
    _check_layout(_rand_rows(rng, 48, scale=8), 0, "long", False)


def test_long_escapes():
    """Magnitudes past 15 force linbits escape tables, including the
    esc-boundary value 15 itself (0-value escape field)."""
    rng = np.random.default_rng(1)
    rows = _rand_rows(rng, 48, scale=120)
    rows[0, 0:2] = (15, -15)          # boundary: esc field of value 0
    rows[1, 0:2] = (100, -2000)       # deep linbits
    _check_layout(rows, 0, "long", False)


def test_long_with_scalefactors():
    rng = np.random.default_rng(2)
    rows = _rand_rows(rng, 32, scale=25)
    lsf = rng.integers(0, 8, (32, 21)).astype(np.int64)
    lsf[3] = 0                        # sf present but all-zero: no part2
    _check_layout(rows, 0, "long", True, lsf=lsf)


def test_switched_start_stop():
    rng = np.random.default_rng(3)
    rows = _rand_rows(rng, 24, scale=20)
    lsf = rng.integers(0, 4, (24, 21)).astype(np.int64)
    for bt in (1, 3):
        _check_layout(rows, bt, "switched", True, lsf=lsf)
        _check_layout(rows, bt, "switched", False)


def test_short_blocks():
    rng = np.random.default_rng(4)
    rows = _rand_rows(rng, 24, scale=18)
    ssf = np.concatenate(
        [rng.integers(0, 16, (24, 3, 6)), rng.integers(0, 8, (24, 3, 6))],
        axis=2).astype(np.int64)
    _check_layout(rows, 2, "short", True, ssf=ssf)
    _check_layout(rows, 2, "short", False)


def test_degenerate_rows():
    """All-zero, count1-only, and single-line rows."""
    rows = np.zeros((6, 576), np.int32)
    rows[1, :8] = [1, -1, 0, 1, -1, 0, 0, 1]       # count1 only
    rows[2, 0] = 3                                  # one big-values pair
    rows[3, 572:576] = [1, 0, -1, 1]                # tail quad
    rows[4, :2] = (8191 + 15, -(8191 + 15))         # max linbits-13 escape
    _check_layout(rows, 0, "long", False)


def test_encode_batch_device_emit_identity(monkeypatch):
    """encode_batch bytes are identical with device emission on (packed
    bytes download, host emitter bypassed) and off (wire spectra +
    native emitter) — transients included so short/switched layouts and
    the pass-B upgrade path are all crossed."""
    import fixtures
    from mp3tpu.encoder import encode_batch
    rng = np.random.default_rng(7)
    t = np.arange(int(1.5 * SR)) / SR
    tone = np.stack([np.sin(2 * np.pi * 330 * t) * 0.5,
                     np.sin(2 * np.pi * 440 * t) * 0.4], 1)
    clicky = fixtures.transients(1.2, SR)
    pcms = [tone, clicky, 0.25 * rng.standard_normal((len(t), 2))]
    monkeypatch.setenv("MP3TPU_DEVICE_EMIT", "1")
    on = encode_batch(pcms, SR, bitrate=128)
    monkeypatch.setenv("MP3TPU_DEVICE_EMIT", "0")
    off = encode_batch(pcms, SR, bitrate=128)
    assert on == off


def test_production_loop_rows():
    """Rows produced by the REAL device rate loop on random spectra:
    emission must agree with the host emitter under the loop's own
    table selections (col mapping exercised end to end)."""
    pytest.importorskip("jax")
    from mp3tpu.encoder import vloop_device
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    n = 16
    xr = (rng.standard_normal((n, 576))
          * 40 * np.exp(-4.0 * np.arange(576) / 576)).astype(np.float32)
    idx = np.arange(n)
    budgets = rng.integers(300, 2400, n).astype(np.int64)
    gg, _has, ix, bits, tsel, c1 = vloop_device.rate_rows_gathered(
        jnp.asarray(xr), idx, budgets, SR, 0)
    tcols = np.vectorize(COL_OF.get)(tsel)
    words, meta = emit_rows_device(
        ix.astype(np.int32), np.zeros((len(ix), 21), np.int32),
        tcols.astype(np.int32), c1.astype(np.int32), SR, "long", False)
    meta = np.asarray(meta)
    got = words_to_bytes(np.asarray(words))
    for i in range(n):
        g = encode_granule(np.asarray(ix[i], np.int32), int(gg[i]), SR, 0,
                           tsel=tuple(int(t) for t in tsel[i]),
                           c1table=int(c1[i]))
        assert int(meta[i, 0]) == g.part2_3_length == int(bits[i]), i
        ref = np.zeros(CAP_WORDS * 4, np.uint8)
        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
        ref[: len(row)] = row
        assert np.array_equal(got[i], ref), i


def _pack_reference(V, L, W):
    """Plain MSB-first bit packing of (value, length) fields into u32."""
    out = np.zeros((len(V), W), np.uint32)
    for r in range(len(V)):
        bits = []
        for v, n in zip(V[r], L[r]):
            bits += [(int(v) >> (n - 1 - k)) & 1 for k in range(n)]
        bits += [0] * (W * 32 - len(bits))
        words = np.packbits(np.asarray(bits, np.uint8)).view(">u4")
        out[r] = words.astype(np.uint32)
    return out


@pytest.mark.parametrize("fields", ["all_ones", "random", "seams"])
def test_pack_words_exact(fields):
    """_pack_words is exact when each 16-bit half of a word is 0xFFFF or
    close (the case TF32 operand rounding would corrupt) and when fields
    straddle 32-bit word seams."""
    import jax
    import jax.numpy as jnp
    from mp3tpu.encoder.emit_device import _pack_words
    rng = np.random.default_rng(11)
    R, F, W = 8, 48, 24
    L = rng.integers(1, 20, (R, F))
    if fields == "seams":   # ends at bit 31, straddles 32, ends at 64
        L = np.resize([16, 15, 2, 15, 16, 2], (R, F))
    V = (1 << L) - 1 if fields != "random" else \
        rng.integers(0, 1 << 19, (R, F)) & ((1 << L) - 1)
    L[:, -3:] = 0                      # dead fields contribute nothing
    got = jax.jit(lambda v, n: _pack_words(jnp, v, n, W))(
        jnp.asarray(V, jnp.int32), jnp.asarray(L, jnp.int32))
    assert np.array_equal(np.asarray(got), _pack_reference(V, L, W))


def test_emit_escape_rows_byte_exact():
    """Rows of maximal linbits escapes (all-ones 13-bit fields) through
    the device emitter, byte-exact against huffcode.encode_granule."""
    rows = np.zeros((4, 576), np.int32)
    rows[0, 0:40] = 8191 + 15                    # all-ones linbits
    rows[1, 1:41:2] = -(8191 + 15)
    rows[2, 0:200] = np.resize([8191 + 15, -(4095 + 15), 15, -16], 200)
    rows[3, 0:64] = np.resize([1023 + 15, 0, -(2047 + 15), 1], 64)
    _check_layout(rows, 0, "long", False)
