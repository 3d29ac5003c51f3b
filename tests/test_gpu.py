"""Contracts checked on the GPU (marker `gpu`).

They skip without a card, and run on it through `python chip_smoke.py`,
inside the smoke's own process. Each pins a contract that the GPU could
break while the CPU keeps it: float32 products rounded to TF32, another
summation order, or another compiled program.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

SR = 44100


def _music(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(150.0, 400.0)
    x = sum(0.08 * np.sin(2 * np.pi * f0 * r * t) for r in (1, 1.5, 2, 3))
    x = np.stack([x, 0.6 * x], 1) + 0.01 * rng.standard_normal((len(t), 2))
    for s in range(2000, len(t) - 300, SR // 3):   # attacks: short blocks
        x[s:s + 300] += 0.5 * rng.standard_normal((300, 2)) \
            * np.hanning(300)[:, None]
    return np.clip(x, -0.99, 0.99)


@pytest.fixture(scope="module")
def mp3s(gpu):
    from mp3tpu import encode_batch
    return encode_batch([_music(3.0, s) for s in range(3)], SR, bitrate=128)


def _quantize_i16(x):
    s = np.asarray(x, np.float64) * 32768.0
    r = np.where(s >= 0, np.floor(s + 0.5), np.ceil(s - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int64)


def test_decode_matches_f64_oracle(gpu, mp3s):
    """float32 within 3e-6 of the oracle; decode_batch int16 within
    1 LSB with >= 98% exact (README correctness contract)."""
    from mp3tpu import decode, decode_batch
    from mp3tpu.dsp.gapless import gapless_bounds
    from mp3tpu.oracle.decoder import decode_symbols
    from mp3tpu.pipeline import load_symbols
    batch = decode_batch(mp3s)
    for mp3, (pcm16, sr) in zip(mp3s, batch):
        st, info, _ = load_symbols(mp3)
        ref = decode_symbols(st)
        f32, _ = decode(mp3, output="float32", gapless=False)
        assert np.abs(f32 - ref).max() <= 3e-6
        a, b = gapless_bounds(len(ref), info.encoder_delay,
                              info.encoder_padding)
        d = np.abs(pcm16.astype(np.int64) - _quantize_i16(ref[a:b]))
        assert d.max() <= 1 and (d == 0).mean() >= 0.98


def test_count_equals_emit_in_bitstream(gpu, mp3s):
    """encode_batch raises on any count/emit drift; the bitstream side:
    every granule's Huffman data ends exactly at part2_3_length."""
    from mp3tpu.bitstream.unpack import unpack_fast
    for mp3 in mp3s:
        st = unpack_fast(mp3)
        assert not st.errors.any() and not st.huff_slack.any()


@pytest.mark.parametrize("layout,bt", [("long", 0), ("switched", 1),
                                       ("short", 2)])
def test_device_emitter_equals_native(gpu, layout, bt):
    """Device Huffman emission (one-hot products of 16-bit halves) is
    byte-identical to the C++ emitter on the device loops' own rows."""
    import jax.numpy as jnp
    from mp3tpu.encoder import native_emit
    from mp3tpu.encoder import vloop_device as vd
    from mp3tpu.encoder.emit_device import emit_rows_device, words_to_bytes
    from mp3tpu.encoder.vcount import TABLE_IDS
    rng = np.random.default_rng(bt)
    R = 512
    xr = (rng.standard_normal((R, 576)) * 30
          * np.exp(-4.0 * np.arange(576) / 576)).astype(np.float32)
    budgets = rng.integers(300, 2600, R)
    idx = np.arange(R)
    lsf = np.zeros((R, 21), np.int64)
    ssf = np.zeros((R, 3, 12), np.int64)
    sbg = np.zeros((R, 3), np.int64)
    if layout == "short":
        xmin = jnp.asarray(np.full((R, 3, 12), 1e-3, np.float32))
        gg, ssf, sbg, _h, ix, _b, tsel, c1 = vd.outer_rows_short_gathered(
            jnp.asarray(xr), xmin, idx, budgets, SR)
    else:
        xmin = jnp.asarray(np.full((R, 21), 1e-3, np.float32))
        gg, lsf, _h, ix, _b, tsel, c1 = vd.outer_rows_gathered(
            jnp.asarray(xr), xmin, idx, budgets, SR, block_type=bt)
    col = {t: c for c, t in enumerate(TABLE_IDS)}
    words, meta = emit_rows_device(
        ix.astype(np.int32), (ssf if layout == "short" else lsf
                              ).astype(np.int32),
        np.vectorize(col.get)(tsel).astype(np.int32), c1.astype(np.int32),
        SR, layout, True)
    got = words_to_bytes(np.asarray(words))
    meta = np.asarray(meta)
    ref = native_emit.encode_rows_native(
        ix, np.full(R, bt), np.ones(R, bool), lsf, ssf, sbg, gg, tsel, c1,
        SR)
    assert ref is not None
    for r, g in enumerate(ref):
        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
        assert int(meta[r, 0]) == g.part2_3_length, r
        assert np.array_equal(got[r, : len(row)], row), r
        assert not got[r, len(row):].any(), r


def test_player_play_equals_decode(gpu, mp3s):
    from mp3tpu.pipeline import decode_file
    from mp3tpu.player import Player
    p = Player(mp3s[0])
    p.play()
    ref, _ = decode_file(mp3s[0])
    assert np.array_equal(p.sink.pcm, ref)
