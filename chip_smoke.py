"""GPU smoke test: mp3tpu's public decode, player and encode paths on one card.

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --multi    # four GPUs: sharded decode + encode only

One process drives the card (a second JAX process would find its memory
taken). The size is BASELINE config 3: 256 distinct 10 s, 44.1 kHz,
joint-stereo, 128 kbps CBR streams, generated from --seed by mp3tpu's own
encoder. Phases, each printing one JSON line with its numbers and the
card's name and power limit:

  env         JAX version, card, compile-cache directory, C++ unpacker built
  inputs      encode_batch of the 256 streams; count == emit on every
              granule; device emitter == C++ emitter byte for byte;
              decode(encode(x)) length and tonal-fixture quality floors
  decode      decode_batch twice (output="pcm", output="device" +
              .numpy()) on the native fast path; sampled streams against
              the float64 oracle
  resample    the config 3 program (packed decode + resample to 48 kHz)
              against the float PCM passed through dsp.resample
  player      Player.play() == decode bit for bit; a seek/loop/EQ/gain/
              speed session with exact sample accounting
  transcode   transcode_batch on 16 streams
  gpu_tests   `pytest -m gpu tests/test_gpu.py`, inside this process

The last line is {"ok": true, "device": {...}}. Without a GPU, or when any
phase fails, the script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.join(_HERE, "src"), os.path.join(_HERE, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SR = 44100
BITRATE = 128
STREAMS, SECONDS = 256, 10.0   # BASELINE config 3
MULTI_STREAMS = 32             # --multi: each of 4 cards holds 8
ORACLE_STREAMS = 4
F32_TOL = 3e-6          # README correctness contract vs the f64 oracle
I16_EXACT_MIN = 0.98    # int16: <= 1 LSB, at least this share exact


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, n_streams: int, seconds: float, seed: int):
        self.n_streams = n_streams
        self.seconds = seconds
        self.seed = seed
        self.card = card()
        self.pcms: list = []
        self.mp3s: list = []
        self.float_ref: dict = {}   # stream -> untrimmed float32 decode

    def report(self, phase: str, **numbers):
        print(json.dumps({"phase": phase, **numbers, "card": self.card}),
              flush=True)

    # ------------------------------------------------------------ inputs
    def signals(self, n: int, seconds: float):
        """n distinct music-like stereo signals (chords, a swept lead,
        percussive hits, a noise bed), int16-origin like WAV input."""
        t = np.arange(int(seconds * SR)) / SR
        out = []
        for i in range(n):
            rng = np.random.default_rng([self.seed, i])
            f0 = rng.uniform(110.0, 440.0)
            chord = sum(rng.uniform(0.04, 0.09)
                        * np.sin(2 * np.pi * f0 * r * t + rng.uniform(0, 6))
                        for r in (1.0, 1.25, 1.5, 2.0, 3.0))
            f1 = rng.uniform(200.0, 800.0)
            k = np.log(rng.uniform(4.0, 12.0))
            lead = 0.2 * np.sin(2 * np.pi * f1 * seconds
                                * (np.exp(t / seconds * k) - 1) / k)
            mix = np.stack([chord + lead, 0.7 * chord + 0.5 * lead], 1)
            mix += rng.uniform(0.002, 0.02) * rng.standard_normal(mix.shape)
            period = int(SR / rng.uniform(1.5, 4.0))
            hit = rng.standard_normal((300, 2)) * np.hanning(300)[:, None]
            for s in range(int(rng.integers(0, period)), len(t) - 300, period):
                mix[s:s + 300] += 0.4 * hit
            out.append(np.clip(np.rint(mix * 32768.0), -32768, 32767)
                       / 32768.0)
        return out

    def phase_env(self):
        import jax
        import mp3tpu
        from mp3tpu.bitstream import native
        from mp3tpu.encoder import native_emit
        t0 = time.perf_counter()
        ok = native.available() and native_emit.available()
        build_s = time.perf_counter() - t0
        if not ok:   # show why: the loader falls back silently
            out = subprocess.run(["make", "-C", native._DIR],
                                 capture_output=True, text=True)
            raise RuntimeError("C++ unpacker/emitter did not build:\n"
                               + (out.stdout + out.stderr)[-3000:])
        self.report("env", jax=jax.__version__,
                    device_kind=jax.devices()[0].device_kind,
                    devices=len(jax.devices()),
                    compile_cache_dir=jax.config.jax_compilation_cache_dir,
                    mp3tpu_cache_dir=mp3tpu.compile_cache_dir(),
                    native=True, native_build_s=build_s)

    def phase_inputs(self):
        import mp3tpu
        import quality_bench as qb
        from mp3tpu.bitstream.unpack import unpack_fast
        t0 = time.perf_counter()
        self.pcms = self.signals(self.n_streams, self.seconds)
        gen_s = time.perf_counter() - t0
        chunk = 64
        walls = []
        for c0 in range(0, self.n_streams, chunk):
            t0 = time.perf_counter()
            # encode_batch raises if any granule's emitted part2_3_length
            # differs from its counted bits (count == emit)
            self.mp3s += mp3tpu.encode_batch(self.pcms[c0:c0 + chunk], SR,
                                             bitrate=BITRATE)
            walls.append(time.perf_counter() - t0)
        # the bitstream side of count == emit: every granule's Huffman
        # data ends exactly at its part2_3_length
        for i, mp3 in enumerate(self.mp3s):
            st = unpack_fast(mp3)
            if st.errors.any() or st.huff_slack.any():
                raise AssertionError(f"stream {i}: errors or part2_3 slack")
        rows = self.emitter_identity()
        for i in (0, self.n_streams - 1):
            pcm, sr = mp3tpu.decode(self.mp3s[i])
            if sr != SR or len(pcm) != len(self.pcms[i]):
                raise AssertionError(f"decode(encode(x)) length {len(pcm)}"
                                     f" != {len(self.pcms[i])}")
        sig = qb.FIXTURES["tonal"](3.0)
        quality = {}
        for name, mp3 in (
                ("encode", mp3tpu.encode(sig, SR, bitrate=BITRATE)),
                ("encode_batch", mp3tpu.encode_batch([sig], SR,
                                                     bitrate=BITRATE)[0])):
            pcm, _ = mp3tpu.decode(mp3, output="float32")
            if len(pcm) != len(sig):
                raise AssertionError(f"{name}: tonal length {len(pcm)}")
            seg, psnr = qb.seg_snr(sig, pcm.astype(np.float64))
            if not (seg > 30.0 and psnr > 45.0):
                raise AssertionError(f"{name}: tonal quality {seg}/{psnr}")
            quality[name] = [seg, psnr]
        audio_s = self.n_streams * self.seconds
        self.report("inputs", streams=self.n_streams, seconds=self.seconds,
                    signal_gen_s=gen_s, encode_batch_walls_s=walls,
                    encode_first_chunk_s=walls[0],
                    encode_warm_x_realtime=(
                        (audio_s - min(chunk, self.n_streams) * self.seconds)
                        / sum(walls[1:]) if len(walls) > 1 else None),
                    emitter_identity_rows=rows,
                    tonal_segsnr_psnr_db=quality)

    def emitter_identity(self) -> int:
        """Device emitter vs the C++ emitter on rate-loop output for the
        same spectra: every layout, with and without scalefactors."""
        import jax.numpy as jnp
        from mp3tpu.encoder import _short_flat_map, native_emit
        from mp3tpu.encoder import vloop_device as vd
        from mp3tpu.encoder.device import granule_spectra_device_batch
        from mp3tpu.encoder.emit_device import (emit_rows_device,
                                                words_to_bytes)
        from mp3tpu.encoder.vcount import TABLE_IDS
        from mp3tpu.encoder.vloop import _SLEN1, _SLEN2
        from mp3tpu.tables.sfb import LONG
        x = np.stack([p[:, 0] for p in self.pcms[:4]])
        G = x.shape[1] // 576
        bts = np.zeros((len(x), G), np.int64)
        for g in range(4, G - 2, 16):         # start, short, stop
            bts[:, g:g + 3] = (1, 2, 3)
        xr = granule_spectra_device_batch(x, bts, SR).reshape(-1, 576)
        bt = bts.reshape(-1)
        p2 = xr * xr
        en_l = np.add.reduceat(p2, LONG[SR][:22], axis=1)[:, :21]
        ind39 = np.zeros((576, 39))
        ind39[np.arange(576), np.minimum(_short_flat_map(SR), 38)] = 1.0
        en_s = (p2 @ ind39).reshape(-1, 3, 13)[:, :, :12]
        rng = np.random.default_rng(self.seed)
        budgets = rng.integers(300, 2600, len(xr))
        xr_dev = jnp.asarray(xr, jnp.float32)
        xl_dev = jnp.asarray(0.03 * en_l, jnp.float32)
        xs_dev = jnp.asarray(0.03 * en_s, jnp.float32)
        col = {t: c for c, t in enumerate(TABLE_IDS)}
        n = 0
        for kind, b in (("long", 0), ("switched", 1), ("switched", 3),
                        ("short", 2), ("rate", 0)):
            idx = np.nonzero(bt == b)[0]
            R = len(idx)
            lsf = np.zeros((R, 21), np.int64)
            ssf = np.zeros((R, 3, 12), np.int64)
            sbg = np.zeros((R, 3), np.int64)
            if kind == "short":
                gg, ssf, sbg, _h, ix, bits, tsel, c1 = \
                    vd.outer_rows_short_gathered(xr_dev, xs_dev, idx,
                                                 budgets[idx], SR)
            elif kind == "rate":
                gg, _h, ix, bits, tsel, c1 = vd.rate_rows_gathered(
                    xr_dev, idx, budgets[idx], SR, b)
            else:
                gg, lsf, _h, ix, bits, tsel, c1 = vd.outer_rows_gathered(
                    xr_dev, xl_dev, idx, budgets[idx], SR, block_type=b)
            use_sf = kind != "rate"
            layout = "long" if kind == "rate" else kind
            sf = ssf if kind == "short" else lsf
            words, meta = emit_rows_device(
                ix.astype(np.int32), sf.astype(np.int32),
                np.vectorize(col.get)(tsel).astype(np.int32),
                c1.astype(np.int32), SR, layout, use_sf)
            dev = words_to_bytes(np.asarray(words))
            meta = np.asarray(meta)
            ref = native_emit.encode_rows_native(
                ix, np.full(R, b), np.full(R, use_sf), lsf, ssf, sbg, gg,
                tsel, c1, SR)
            if ref is None:
                raise RuntimeError("native emitter unavailable")
            for r, g in enumerate(ref):
                row = np.packbits(np.asarray(g.bits.bits, np.uint8))
                want = np.zeros(dev.shape[1], np.uint8)
                want[: len(row)] = row
                got = (meta[r, 0], meta[r, 1], meta[r, 2], meta[r, 3],
                       meta[r, 4])
                exp = (g.part2_3_length, g.big_values, g.scalefac_compress,
                       g.region0_count, g.region1_count)
                if not np.array_equal(dev[r], want) or got != exp:
                    raise AssertionError(f"{kind} bt={b} row {r}: device "
                                         "emitter != C++ emitter")
            # count == emit: emitted bits are the count kernel's Huffman
            # bits plus the side bits of the chosen scalefac_compress
            sfc = meta[:, 2].astype(np.int64)
            sf_bits = (0 if not use_sf else
                       18 * (_SLEN1[sfc] + _SLEN2[sfc]) if kind == "short"
                       else 11 * _SLEN1[sfc] + 10 * _SLEN2[sfc])
            if not np.array_equal(meta[:, 0], bits + sf_bits):
                raise AssertionError(f"{kind} bt={b}: count != emit")
            n += R
        return n

    # ------------------------------------------------------------ decode
    def phase_decode(self):
        import jax
        import mp3tpu
        from mp3tpu.oracle.decoder import decode_symbols
        from mp3tpu.dsp.gapless import gapless_bounds
        from mp3tpu.pipeline import load_symbols
        from mp3tpu.player import scheduler

        def no_fallback(*_a, **_k):
            raise AssertionError("decode_batch left the native fast path")

        fallback = scheduler.decode_batch_streams
        scheduler.decode_batch_streams = no_fallback
        try:
            t0 = time.perf_counter()
            pcm_out = mp3tpu.decode_batch(self.mp3s)
            t_pcm_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            handle = mp3tpu.decode_batch(self.mp3s, output="device")
            jax.block_until_ready([handle.device_pcm(i)[0]
                                   for i in range(len(handle))])
            t_dev_cold = time.perf_counter() - t0
            if any(isinstance(handle.device_pcm(i)[0], np.ndarray)
                   for i in range(len(handle))):
                raise AssertionError("device handle holds host records")
            dev_out = handle.numpy()
            t0 = time.perf_counter()
            mp3tpu.decode_batch(self.mp3s)
            t_pcm_warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            handle = mp3tpu.decode_batch(self.mp3s, output="device")
            jax.block_until_ready([handle.device_pcm(i)[0]
                                   for i in range(len(handle))])
            t_dev_warm = time.perf_counter() - t0
        finally:
            scheduler.decode_batch_streams = fallback
        d_max = 0
        for (a, sa), (b, sb), x in zip(pcm_out, dev_out, self.pcms):
            if sa != SR or sb != SR or a.shape != b.shape or \
                    len(a) != len(x):
                raise AssertionError("decode_batch shapes/rates")
            d_max = max(d_max, int(np.abs(a.astype(np.int32)
                                          - b.astype(np.int32)).max()))
        if d_max > 1:
            raise AssertionError(f"pcm vs device outputs differ by {d_max}")

        f32_err, i16_max, i16_exact = [], [], []
        picks = np.linspace(0, self.n_streams - 1, ORACLE_STREAMS).astype(int)
        for i in picks:
            data = self.mp3s[i]
            st, info, _ = load_symbols(data)
            ref = decode_symbols(st)
            f32, _ = mp3tpu.decode(data, output="float32", gapless=False)
            self.float_ref[int(i)] = f32
            f32_err.append(float(np.abs(f32 - ref).max()))
            a, b = gapless_bounds(len(ref), info.encoder_delay,
                                  info.encoder_padding)
            q = _quantize_i16(ref[a:b])
            d = np.abs(pcm_out[i][0].astype(np.int64) - q)
            i16_max.append(int(d.max()))
            i16_exact.append(float((d == 0).mean()))
        audio_s = sum(len(p) for p, _ in pcm_out) / SR
        self.report("decode_batch", streams=len(pcm_out), audio_s=audio_s,
                    pcm_cold_s=t_pcm_cold, device_cold_s=t_dev_cold,
                    pcm_warm_s=t_pcm_warm, device_warm_s=t_dev_warm,
                    pcm_warm_x_realtime=audio_s / t_pcm_warm,
                    device_warm_x_realtime=audio_s / t_dev_warm,
                    pcm_vs_device_max_lsb=d_max,
                    oracle_streams=[int(i) for i in picks],
                    oracle_f32_max_err=f32_err, oracle_i16_max_lsb=i16_max,
                    oracle_i16_exact_share=i16_exact)
        if max(f32_err) > F32_TOL or max(i16_max) > 1 or \
                min(i16_exact) < I16_EXACT_MIN:
            raise AssertionError("decode outside the oracle contract")

    # ---------------------------------------------------------- resample
    def packed_batch(self, mp3s):
        """Window-major packed planes of the given streams (the C++
        fast path's staging layout, 4-bit plane widened on overflow)."""
        import ctypes
        from mp3tpu.bitstream import native
        from mp3tpu.container import frames as fr
        lib = native._load()
        meta4 = (ctypes.c_int32 * 4)()
        bodies, Gs = [], []
        for mp3 in mp3s:
            index = fr.scan_frames(np.frombuffer(mp3, np.uint8))
            body = mp3[int(index.offsets[1]):]   # drop the Xing frame
            bodies.append(body)
            Gs.append(lib.mp3tpu_probe(body, len(body), meta4))
        S, win = len(mp3s), 32
        n_win = -(-max(Gs) // win)
        for plane_bits in (4, 8, 12):
            shp = {4: 288, 8: 576, 12: 864}[plane_bits]
            dt = {4: np.uint8, 8: np.int8, 12: np.uint8}[plane_bits]
            esc = {4: (80,), 8: (16, 2), 12: (16, 2)}[plane_bits]
            b = {
                "is12": np.zeros((n_win, S, win, 2, shp), dt),
                "exp": np.zeros((n_win, S, win, 2, 65), np.uint8),
                "esc": np.zeros((n_win, S, win, 2) + esc,
                                np.int8 if plane_bits == 4 else np.int16),
                "bt": np.zeros((n_win, S, win, 2), np.int8),
                "mx": np.zeros((n_win, S, win, 2), np.uint8),
                "smode": np.zeros((n_win, S, win, 64), np.uint8),
            }
            if all(native.unpack_native_into12(
                    body, G, None, b["exp"], b["bt"], b["mx"], b["smode"],
                    b["is12"], b["esc"], k, S, win,
                    plane_bits=plane_bits | 0x10)
                   for k, (body, G) in enumerate(zip(bodies, Gs))):
                keys = ("is12", "exp", "esc", "bt", "mx", "smode")
                return tuple(b[k] for k in keys), plane_bits, Gs
        raise RuntimeError("packed planes overflowed every width")

    def phase_resample(self):
        import jax
        from mp3tpu.dsp.resample import resample
        from mp3tpu.kernels import pipeline as kp
        t0 = time.perf_counter()
        planes, plane_bits, Gs = self.packed_batch(self.mp3s)
        unpack_s = time.perf_counter() - t0
        S = len(self.mp3s)
        t0 = time.perf_counter()
        dev = jax.block_until_ready(tuple(jax.device_put(a) for a in planes))
        stage_s = time.perf_counter() - t0

        def run():
            return jax.block_until_ready(kp.decode_all_windows_flat_resampled_i16(
                *dev, kp.init_state(S), kp.init_resample_state(S, SR), SR,
                48000, plane_bits=plane_bits))

        t0 = time.perf_counter()
        out, _st, _rs = run()
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out, _st, _rs = run()
            times.append(time.perf_counter() - t0)
        # the decode scan alone (no resample): the bar a hand-written
        # decode front end would have to beat end to end
        n_win = planes[0].shape[0]
        wins = [tuple(a[w] for a in dev) for w in range(n_win)]
        i12, ex, es, bt, mx, sm = zip(*wins)

        def scan():
            return jax.block_until_ready(kp.decode_windows_scan_i16(
                i12, es, ex, bt, mx, sm, kp.init_state(S), SR,
                plane_bits=plane_bits))

        scan()
        scan_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            scan()
            scan_times.append(time.perf_counter() - t0)
        out = np.asarray(out)
        worst, exact = 0, 1.0
        for i, f32 in self.float_ref.items():
            ref = _quantize_i16(np.asarray(resample(f32, SR, 48000)))
            n = min(len(ref), Gs[i] * 576 * 48000 // SR - 64)
            d = np.abs(out[i, :n, :ref.shape[1]].astype(np.int64) - ref[:n])
            worst = max(worst, int(d.max()))
            exact = min(exact, float((d == 0).mean()))
        audio_s = sum(Gs) * 576 / SR
        self.report("decode_resample48k", streams=S, audio_s=audio_s,
                    plane_bits=plane_bits, host_unpack_s=unpack_s,
                    stage_s=stage_s, first_call_s=first_s,
                    device_s=times, device_x_realtime=audio_s / min(times),
                    decode_scan_only_s=scan_times,
                    checked_streams=sorted(self.float_ref),
                    max_lsb=worst, exact_share=exact)
        if worst > 1:
            raise AssertionError(f"resampled decode off by {worst} LSB")

    # ------------------------------------------------------------ player
    def phase_player(self):
        from mp3tpu.dsp.timestretch import HOP_SYN
        from mp3tpu.pipeline import decode_file
        from mp3tpu.player import Player
        mp3 = self.mp3s[0]
        ref, _ = decode_file(mp3)
        p = Player(mp3)
        t0 = time.perf_counter()
        p.play()
        play_s = time.perf_counter() - t0
        if not np.array_equal(p.sink.pcm, ref):
            raise AssertionError("Player.play() != decode_file")

        dur = len(ref)
        p = Player(mp3, gain_db=-3.0,
                   eq_gains_db=[0, 0, 1, 2, 0, -2, 0, 1, 0, 0])
        expect = 0
        t0 = time.perf_counter()
        p.seek(2.0)
        expect += p.play(max_samples=2 * SR)
        seg = int(round(5.5 * SR)) - int(round(4.0 * SR))
        p.loop(4.0, 5.5, times=3)
        expect += 3 * seg
        p.set_speed(0.75)
        seg = int(round(7.0 * SR)) - int(round(6.0 * SR))
        ha = int(round(HOP_SYN * 0.75))
        p.loop(6.0, 7.0, times=2)
        expect += 2 * (-(-seg // ha)) * HOP_SYN
        p.set_speed(1.0)
        p.seek(8.0)
        p.play()
        expect += dur - 8 * SR
        session_s = time.perf_counter() - t0
        got = len(p.sink.pcm)
        self.report("player", play_s=play_s,
                    play_x_realtime=dur / SR / play_s,
                    session_s=session_s, session_samples=got,
                    expected_samples=expect,
                    underruns=p.metrics.underruns, seeks=p.metrics.seeks)
        if got != expect or p.metrics.underruns != 0:
            raise AssertionError(f"session emitted {got} != {expect} "
                                 f"or underruns {p.metrics.underruns}")

    # --------------------------------------------------------- transcode
    def phase_transcode(self):
        import mp3tpu
        srcs = self.mp3s[:16]
        t0 = time.perf_counter()
        outs = mp3tpu.transcode_batch(srcs, bitrate=BITRATE)
        wall = time.perf_counter() - t0
        for src, out in zip(srcs, outs):
            want = len(mp3tpu.decode(src)[0])
            got = len(mp3tpu.decode(out)[0])
            if got != want:
                raise AssertionError(f"transcode length {got} != {want}")
        self.report("transcode", streams=len(srcs), wall_s=wall,
                    x_realtime=len(srcs) * self.seconds / wall)

    # --------------------------------------------------------- gpu tests
    def phase_gpu_tests(self):
        import pytest

        class Tally:
            def __init__(self):
                self.passed, self.other = 0, []

            def pytest_runtest_logreport(self, report):
                if report.when == "call" and report.passed:
                    self.passed += 1
                elif not report.passed:
                    self.other.append((report.nodeid, report.outcome))

        tally = Tally()
        t0 = time.perf_counter()
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(_HERE, "tests", "test_gpu.py")],
                         plugins=[tally])
        self.report("gpu_tests", rc=int(rc), passed=tally.passed,
                    not_passed=tally.other,
                    wall_s=time.perf_counter() - t0)
        if rc != 0 or tally.other or not tally.passed:
            raise AssertionError("gpu-marked tests did not all pass")

    # ------------------------------------------------------- four cards
    def phase_multi(self, n_dev: int = 4):
        import jax
        import mp3tpu
        from jax.sharding import NamedSharding, PartitionSpec as P
        from mp3tpu.kernels import pipeline as kp
        from mp3tpu.parallel.mesh import make_stream_mesh
        mesh = make_stream_mesh(n_dev)
        self.pcms = self.signals(self.n_streams, self.seconds)
        t0 = time.perf_counter()
        one = mp3tpu.encode_batch(self.pcms, SR, bitrate=BITRATE)
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        shard = mp3tpu.encode_batch(self.pcms, SR, bitrate=BITRATE,
                                    mesh=mesh)
        t_shard = time.perf_counter() - t0
        same = sum(a == b for a, b in zip(one, shard))

        planes, plane_bits, _Gs = self.packed_batch(one)
        S = len(one)
        ref, _, _ = kp.decode_all_windows_flat_resampled_i16(
            *(jax.device_put(a) for a in planes), kp.init_state(S),
            kp.init_resample_state(S, SR), SR, 48000, plane_bits=plane_bits)
        ref = np.asarray(ref)
        win_sh = NamedSharding(mesh, P(None, "streams"))
        row_sh = NamedSharding(mesh, P("streams"))
        got, _, _ = kp.decode_all_windows_flat_resampled_i16(
            *(jax.device_put(a, win_sh) for a in planes),
            jax.tree.map(lambda a: jax.device_put(a, row_sh),
                         kp.init_state(S)),
            jax.device_put(kp.init_resample_state(S, SR), row_sh), SR,
            48000, plane_bits=plane_bits)
        spans = len(got.sharding.device_set)
        d = np.abs(ref.astype(np.int32) - np.asarray(got).astype(np.int32))
        self.report("multi", devices=n_dev, streams=S,
                    encode_one_card_s=t_one, encode_sharded_s=t_shard,
                    encode_identical_streams=int(same),
                    decode_output_devices=spans, decode_max_lsb=int(d.max()),
                    decode_exact_share=float((d == 0).mean()))
        if same != S or spans != n_dev or d.max() > 1:
            raise AssertionError("sharded path disagrees with one card")


def _quantize_i16(x):
    """float PCM -> int16 as kernels.pipeline.quantize_i16 rounds."""
    s = np.asarray(x, np.float64) * 32768.0
    r = np.where(s >= 0, np.floor(s + 0.5), np.ceil(s - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int64)


def run(smoke: Smoke, multi: bool):
    if multi:
        smoke.phase_multi()
        return
    for phase in (smoke.phase_env, smoke.phase_inputs, smoke.phase_decode,
                  smoke.phase_resample, smoke.phase_player,
                  smoke.phase_transcode, smoke.phase_gpu_tests):
        phase()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: sharded decode and encode vs one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    n_dev = 4 if args.multi else 1
    if len(devs) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    smoke = Smoke(MULTI_STREAMS if args.multi else STREAMS, SECONDS,
                  args.seed)
    print(f"card: {smoke.card}", flush=True)
    run(smoke, args.multi)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
