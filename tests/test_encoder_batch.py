"""Batched encoder (SURVEY.md §3.4, BASELINE config 5 aggregate path):
device lockstep loops, native batched emitter, packed mux, encode_batch
end-to-end — each stage pinned against its scalar/Python reference.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from mp3tpu.encoder import encode_batch, encode_pcm
from mp3tpu.encoder import native_emit, vloop_device
from mp3tpu.encoder.huffcode import encode_granule
from mp3tpu.encoder.vcount import count_bits_rows, count_bits_rows_full
from mp3tpu.pipeline import decode_file

SR = 44100


def _random_rows(rng, R, max_mag=8, cap_bits=3500):
    ix = np.zeros((R, 576), np.int32)
    bt = rng.choice([0, 0, 0, 2, 1, 3], R)
    for r in range(R):
        n = rng.integers(10, 300)
        pos = rng.choice(500, n, replace=False)
        ix[r, pos] = np.round(rng.standard_normal(n) *
                              rng.choice([1, 1, 2, 3, max_mag])).astype(np.int32)
    bits = np.zeros(R, np.int64)
    for b in (0, 1, 2, 3):
        m = bt == b
        if m.any():
            bits[m] = count_bits_rows(ix[m], SR, int(b))
    keep = bits < cap_bits
    return ix[keep], bt[keep]


def _tsel_of(ix, bt):
    R = len(ix)
    tsel = np.zeros((R, 3), np.int64)
    c1t = np.zeros(R, np.int64)
    for b in (0, 1, 2, 3):
        m = bt == b
        if m.any():
            _, sel = count_bits_rows_full(ix[m], SR, int(b))
            tsel[m, 0], tsel[m, 1], tsel[m, 2] = sel["t0"], sel["t1"], sel["t2"]
            c1t[m] = sel["c1table"]
    return tsel, c1t


def test_device_count_matches_vcount():
    """The jnp bit counter is integer-exact vs vcount row-for-row,
    including table and count1 selections."""
    rng = np.random.default_rng(0)
    ix = np.zeros((48, 576), np.int32)
    for r in range(48):
        n = rng.integers(50, 400)
        pos = rng.choice(576, n, replace=False)
        ix[r, pos] = np.round(rng.standard_normal(n) *
                              rng.choice([1, 2, 5, 30, 200])).astype(np.int32)
    C = vloop_device._device_consts(SR)
    for short in (False, True):
        ref, sel = count_bits_rows_full(ix, SR, 2 if short else 0)
        bits, selr, _bv, _k, c1 = vloop_device._count_rows(
            jnp, C, jnp.asarray(ix), short)
        assert np.array_equal(np.asarray(bits), ref)
        got_t = vloop_device._TID[np.asarray(selr)]
        assert np.array_equal(got_t,
                              np.stack([sel["t0"], sel["t1"], sel["t2"]], 1))
        assert np.array_equal(np.asarray(c1), sel["c1table"])


def test_device_rate_loop_contract():
    """Device bisection returns spectra whose EXACT count fits the
    budget (the count == emit contract), matching numpy gg closely."""
    from mp3tpu.encoder import vloop
    rng = np.random.default_rng(1)
    R = 48
    xr = rng.standard_normal((R, 576)) * \
        np.exp(-np.arange(576) / 120)[None] * rng.uniform(0.01, 2.0, (R, 1))
    budg = rng.integers(500, 3000, R).astype(np.int64)
    gg, has, ix, bits, tsel, c1 = vloop_device.rate_rows_device(
        xr, budg, SR, 0)
    assert has.all()
    # device-reported bits are the exact count of the returned ix
    assert np.array_equal(bits, count_bits_rows(ix.astype(np.int32), SR, 0))
    assert (bits <= budg).all()
    ix_n, gg_n = vloop.inner_rate_rows(xr, budg, SR, 0)
    assert np.abs(gg - gg_n).max() <= 1  # f32 boundary flips only


def test_native_emitter_matches_python():
    """C++ batched emitter == encode_granule bit-for-bit + metadata."""
    if not native_emit.available():
        pytest.skip("native emitter unavailable")
    rng = np.random.default_rng(3)
    ix, bt = _random_rows(rng, 200)
    R = len(ix)
    lsf = rng.integers(0, 8, (R, 21))
    ssf = rng.integers(0, 6, (R, 3, 12))
    sbg = rng.integers(0, 3, (R, 3))
    gg = rng.integers(100, 250, R)
    use_sf = (bt == 0) | (bt == 2)
    tsel, c1t = _tsel_of(ix, bt)
    got = native_emit.encode_rows_native(ix, bt, use_sf, lsf, ssf, sbg,
                                         gg, tsel, c1t, SR)
    assert got is not None
    for r in range(R):
        b = int(bt[r])
        kw = {}
        if use_sf[r] and b == 0:
            kw = dict(long_sf=lsf[r])
        if use_sf[r] and b == 2:
            kw = dict(short_sf=ssf[r],
                      subblock_gain=tuple(int(x) for x in sbg[r]))
        ref = encode_granule(ix[r], int(gg[r]), SR, b, tsel=tsel[r],
                             c1table=int(c1t[r]), **kw)
        g = got[r]
        assert g.bits.bits == ref.bits.bits, r
        assert g.part2_3_length == ref.part2_3_length
        assert g.big_values == ref.big_values
        assert g.scalefac_compress == ref.scalefac_compress
        assert (g.region0_count, g.region1_count) == \
            (ref.region0_count, ref.region1_count)
        assert g.table_select == ref.table_select
        assert g.count1table_select == ref.count1table_select


def test_packed_mux_matches_reservoir_mux():
    """mux_packed.assemble_stream is byte-identical to the
    CodedGranule/ReservoirMux path for the same granule data."""
    from mp3tpu.encoder.mux import FrameSizer, ReservoirMux
    from mp3tpu.encoder.mux_packed import assemble_stream
    rng = np.random.default_rng(4)
    n_frames = 24
    nch = 2
    # rows must respect the frame budget (4 gc share ~3700 bits at
    # 128 kbps stereo) or the mux legitimately refuses the overdraft
    ix, bt = _random_rows(rng, 6 * n_frames * nch, cap_bits=800)
    need = n_frames * 2 * nch
    ix, bt = ix[:need], bt[:need]
    assert len(ix) == need
    gg = rng.integers(100, 250, need)
    tsel, c1t = _tsel_of(ix, bt)
    coded = [encode_granule(ix[i], int(gg[i]), SR, int(bt[i]),
                            tsel=tsel[i], c1table=int(c1t[i]))
             for i in range(need)]
    ms_f = rng.random(n_frames) < 0.5
    mux = ReservoirMux(nch, 0, 9, FrameSizer(SR, 128000))
    for f in range(n_frames):
        granules = [[coded[f * 2 * nch + gr * nch + c] for c in range(nch)]
                    for gr in range(2)]
        mux.add_frame(granules, bool(ms_f[f]))
    ref = mux.finish()

    CAP = native_emit._CAP
    bits_bytes = np.zeros((need, CAP), np.uint8)
    p23 = np.zeros(need, np.int64)
    bv = np.zeros(need, np.int64)
    sfc = np.zeros(need, np.int64)
    r0c = np.zeros(need, np.int64)
    r1c = np.zeros(need, np.int64)
    sbg = np.zeros((need, 3), np.int64)
    for i, g in enumerate(coded):
        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
        bits_bytes[i, : len(row)] = row
        p23[i] = g.part2_3_length
        bv[i] = g.big_values
        sfc[i] = g.scalefac_compress
        r0c[i], r1c[i] = g.region0_count, g.region1_count
    got = assemble_stream(bits_bytes, p23, bv, gg, sfc, bt, tsel, sbg,
                          r0c, r1c, c1t, ms_f, nch, 0, 9, SR, 128)
    assert got == ref


def _snr(mp3, ref):
    dec, _ = decode_file(bytes(mp3), output="float32")
    m = min(len(dec), len(ref))
    err = dec[:m].astype(np.float64) - ref[:m]
    return 10 * np.log10((ref[:m] ** 2).mean() /
                         max((err ** 2).mean(), 1e-30))


def test_encode_batch_roundtrip_quality():
    """encode_batch streams decode at the same quality as encode_pcm
    and are conformant (own decoder applies the gapless trim)."""
    sr = SR
    n = sr
    t = np.arange(n) / sr
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 2500 * t)
    pcm = np.stack([sig, 0.7 * sig], 1)
    rng = np.random.default_rng(5)
    tr = 0.02 * rng.standard_normal((n, 2))
    for i in range(0, n - 500, sr // 6):
        tr[i:i + 300] += 0.7 * rng.standard_normal((300, 2)) * \
            np.hanning(300)[:, None]
    outs = encode_batch([pcm, tr], sr, bitrate=128)
    ref0 = _snr(encode_pcm(pcm, sr), pcm)
    got0 = _snr(outs[0], pcm)
    assert got0 > 45 and abs(got0 - ref0) < 3.0
    got1 = _snr(outs[1], tr)
    ref1 = _snr(encode_pcm(tr, sr), tr)
    assert abs(got1 - ref1) < 3.0
    # output length matches input (gapless round trip)
    dec, _ = decode_file(bytes(outs[0]))
    assert len(dec) == n


def test_encode_batch_mono_and_noshape():
    sr = SR
    n = sr // 2
    t = np.arange(n) / sr
    sig = 0.5 * np.sin(2 * np.pi * 700 * t)
    outs = encode_batch([sig, sig * 0.3], sr, bitrate=128)
    assert _snr(outs[0], sig[:, None]) > 50
    ns = encode_batch([np.stack([sig, sig], 1)], sr,
                      noise_shaping=False)[0]
    assert _snr(ns, np.stack([sig, sig], 1)) > 50


def test_encode_batch_vs_libmpg123():
    """Conformance: a third-party decoder accepts batch output."""
    try:
        import mpg123ref
    except Exception:
        pytest.skip("libmpg123 anchor unavailable")
    sr = SR
    n = sr // 2
    t = np.arange(n) / sr
    sig = 0.4 * np.sin(2 * np.pi * 440 * t)
    pcm = np.stack([sig, 0.6 * sig], 1)
    out = encode_batch([pcm], sr, bitrate=128)[0]
    r = mpg123ref.decode(bytes(out))
    dec = np.asarray(r[0] if isinstance(r, tuple) else r)
    assert len(dec) > n  # decodes (includes codec delay padding)


def test_encode_pcm_device_loops_routing():
    """encode_pcm(device_loops=True) is byte-identical to the B=1
    batch path (the routing is pure delegation, no second policy), and
    the default resolution keeps the host reference path on CPU-only
    backends."""
    sr = SR
    n = sr  # 1 s stereo
    t = np.arange(n) / sr
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * np.sin(2 * np.pi * 3000 * t)
    pcm = np.stack([sig, 0.7 * sig], 1)
    routed = encode_pcm(pcm, sr, bitrate=128, device_loops=True)
    direct = encode_batch([pcm], sr, bitrate=128)[0]
    assert routed == direct
    # VBR stays host-only through the routing gate
    with pytest.raises(ValueError):
        encode_pcm(pcm, sr, vbr_quality=4, device_loops=True)
    if jax.default_backend() == "cpu":
        host = encode_pcm(pcm, sr, bitrate=128)
        ref = encode_pcm(pcm, sr, bitrate=128, device_loops=False)
        assert host == ref


def test_int16_staging_bit_identical():
    """int16-origin input (WAV/decoder output) stages at half the H2D
    bytes; k/2^15 dequantized on device is exact in f32, so the encoded
    bytes must be IDENTICAL to the f32 staging path."""
    from mp3tpu.encoder import device as edev
    from mp3tpu.encoder import encode_batch
    rng = np.random.default_rng(5)
    sr = 44100
    n = int(0.4 * sr)
    t = np.arange(n) / sr
    pcms = []
    for i in range(3):
        x = 0.4 * np.sin(2 * np.pi * (300 + 60 * i) * t) \
            + 0.05 * rng.standard_normal(n)
        k = np.clip(np.rint(x * 32768.0), -32768, 32767)
        pcms.append((k / 32768.0).astype(np.float64))
    ref = None
    edev.FORCE_F32_STAGE = True
    try:
        ref = encode_batch(pcms, sr, bitrate=128)
    finally:
        edev.FORCE_F32_STAGE = False
    got = encode_batch(pcms, sr, bitrate=128)
    assert all(a == b for a, b in zip(ref, got))
    # non-integral input must take (and keep) the f32 path unchanged
    bad = [p + 1e-9 for p in pcms]
    out = encode_batch(bad, sr, bitrate=128)
    assert all(len(b) > 400 for b in out)


def test_native_mux_byte_identical():
    """The C++ mux (native/mux_stream.cpp) must be byte-identical to
    the Python reference for real encodes, including streams that
    saturate the reservoir back-window (quiet audio drives the walk's
    MAX_BACK=400 clamp every frame — the clamp is where a native port
    can silently diverge; it did during development)."""
    from mp3tpu.bitstream import native as bnat
    from mp3tpu.encoder import encode_batch, mux_packed
    if bnat._load() is None or not hasattr(bnat._load(), "mp3tpu_mux_stream"):
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    sr = 44100
    n = int(1.2 * sr)
    t = np.arange(n) / sr
    loud = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    loud[n // 2: n // 2 + 800] += 0.5 * rng.standard_normal(800)  # short blocks
    quiet = 0.003 * np.sin(2 * np.pi * 220 * t)  # reservoir clamp saturates
    for streams in ([np.stack([loud, 0.7 * loud], 1), quiet[:, None] * [1, 1]],
                    [loud[:, None]], [quiet[:, None]]):
        mux_packed.FORCE_PYTHON_MUX = True
        try:
            ref = encode_batch(streams, sr, bitrate=128)
        finally:
            mux_packed.FORCE_PYTHON_MUX = False
        got = encode_batch(streams, sr, bitrate=128)
        assert all(a == b for a, b in zip(ref, got))


@pytest.mark.parametrize("short", [False, True], ids=["long", "short"])
def test_device_count_edge_rows_match_vcount(short):
    """The device count (the GPU's form) on edge rows — all-zero, the
    deepest linbits escape, dense large values — integer-exact vs vcount
    row-for-row, tables and count1 selection included."""
    rng = np.random.default_rng(5)
    ix = np.zeros((64, 576), np.int32)
    for r in range(64):
        n = rng.integers(20, 500)
        pos = rng.choice(576, n, replace=False)
        ix[r, pos] = np.round(rng.standard_normal(n) *
                              rng.choice([1, 2, 5, 30, 900])).astype(np.int32)
    ix[0] = 0                                   # all-zero row
    ix[1, :4] = (8191 + 15, -3, 1, 0)           # deepest escape
    ix[2, :576] = np.resize([1, -1, 0, 1], 576)  # count1 to the last line
    C = vloop_device._device_consts(SR)
    ref, sel = count_bits_rows_full(ix, SR, 2 if short else 0)
    bits, selr, _bv, _k, c1 = jax.jit(
        lambda a: vloop_device._count_rows(jnp, C, a, short))(jnp.asarray(ix))
    assert np.array_equal(np.asarray(bits), ref)
    assert np.array_equal(vloop_device._TID[np.asarray(selr)],
                          np.stack([sel["t0"], sel["t1"], sel["t2"]], 1))
    assert np.array_equal(np.asarray(c1), sel["c1table"])


@pytest.mark.parametrize("which", ["rate_loop_dims", "encode_routing"])
def test_backend_choice_is_explicit(which, monkeypatch):
    """Row blocking and single-stream routing are chosen per named
    backend; a backend with no entry is an error, never a default."""
    from mp3tpu import encoder
    if which == "rate_loop_dims":
        assert vloop_device._dims() == (256, 512)          # CPU blocking
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(ValueError, match="rocm"):
            vloop_device._dims()
    else:
        assert encoder._device_min_granules() is None     # CPU: host path
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(ValueError, match="rocm"):
            encoder._device_min_granules()
