"""Encoder quality head-to-head vs the system LAME (VERDICT r2 task 7;
SURVEY.md §4.2 trust-anchor philosophy applied to the encoder).

For each fixture class (tonal chords, transients, pink noise, and a
real-music-like chirp mix), encode at 128 kbps CBR joint-stereo with

  * mp3tpu, psymodel 2 on  (the default: noise_shaping=True)
  * mp3tpu, psymodel 2 off (plain inner-loop rate control)
  * system libmp3lame      (the de-facto best MP3 encoder, q=2)

decode ALL streams with the same neutral referee (system libmpg123 —
never either encoder's own decoder), align to the source by FFT
cross-correlation (absorbs each encoder's delay + metadata frame), and
report segmental SNR (20 ms frames, per-frame clamp [-10, 35] dB,
silent frames skipped) plus plain PSNR over the aligned overlap.

Run: python tools/quality_bench.py            (prints table + JSON line)
Imported by tests/test_encoder_quality.py for the regression floors.

Both referee libraries are TEST/BENCH-TIME anchors only (CLAUDE.md):
the framework never imports them at runtime.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(_REPO, "src"), os.path.join(_REPO, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)

SR = 44100
BITRATE = 128


# ---------------------------------------------------------------- fixtures

def fixture_tonal(seconds: float = 3.0) -> np.ndarray:
    """Dense harmonic chord stack — the content PM2's tonality masking
    is built for (tonal maskers get the strict TMN offset)."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    base = sum(0.11 * np.sin(2 * np.pi * f * t + 0.7 * f) for f in
               (196.0, 392.0, 587.0, 784.0, 1175.0, 2350.0, 4699.0, 9397.0))
    lr = np.stack([base, 0.6 * base + 0.002 * np.sin(2 * np.pi * 8500 * t)], 1)
    return lr


def fixture_transient(seconds: float = 3.0) -> np.ndarray:
    """Percussive hit train over a quiet bed — exercises block switching
    and PM2's pre-echo control."""
    n = int(seconds * SR)
    rng = np.random.default_rng(77)
    sig = 0.015 * rng.standard_normal((n, 2))
    period = SR // 6
    for i in range(period // 2, n - 600, period):
        burst = rng.standard_normal((400, 2)) * np.hanning(400)[:, None]
        tone = np.sin(2 * np.pi * 1800 * np.arange(400) / SR)
        sig[i:i + 400] += 0.75 * burst * 0.4 + 0.5 * np.stack([tone, tone], 1) \
            * np.hanning(400)[:, None]
    return np.clip(sig, -0.99, 0.99)


def fixture_noise(seconds: float = 3.0) -> np.ndarray:
    """Stereo pink noise — worst case for parametric coding, flat bit
    demand everywhere; separates the rate loops from the psymodel."""
    n = int(seconds * SR)
    rng = np.random.default_rng(123)
    white = rng.standard_normal((n + 4096, 2))
    spec = np.fft.rfft(white, axis=0)
    f = np.maximum(np.fft.rfftfreq(len(white), 1 / SR), 20.0)
    pink = np.fft.irfft(spec / np.sqrt(f)[:, None], len(white), axis=0)[2048:2048 + n]
    return 0.35 * pink / np.abs(pink).max()


def fixture_chirpmix(seconds: float = 3.0) -> np.ndarray:
    """Real-music-like mix: sweeping lead over sustained chords, a
    percussive pulse, and a low noise floor — every encoder subsystem
    at once (tonality tracking, block switching, stereo imaging)."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    k = np.log(4000.0 / 200.0)
    phase = 2 * np.pi * 200.0 * (np.exp(t / t[-1] * k) - 1) * t[-1] / k
    lead = 0.28 * np.sin(phase) + 0.1 * np.sin(2.0 * phase)
    chords = sum(0.07 * np.sin(2 * np.pi * f * t + f) for f in
                 (146.8, 220.0, 293.7, 440.0, 880.0))
    rng = np.random.default_rng(9)
    bed = 0.01 * rng.standard_normal((n, 2))
    mix = bed + np.stack([lead + chords, 0.8 * chords + 0.6 * lead], 1)
    period = SR // 2
    for i in range(period // 4, n - 300, period):
        mix[i:i + 250] += 0.45 * (rng.standard_normal((250, 2))
                                  * np.hanning(250)[:, None])
    return np.clip(mix, -0.99, 0.99)


FIXTURES = {
    "tonal": fixture_tonal,
    "transient": fixture_transient,
    "noise": fixture_noise,
    "chirpmix": fixture_chirpmix,
}


# ------------------------------------------------------------------ metric

def align_lag(ref: np.ndarray, dec: np.ndarray, max_lag: int = 8192) -> int:
    """Lag d >= 0 such that dec[d:] best matches ref (FFT xcorr on the
    mono mixdowns). Absorbs encoder delay + leading metadata frame."""
    a = ref.mean(1)
    b = dec.mean(1)
    n = 1 << int(np.ceil(np.log2(len(a) + len(b))))
    corr = np.fft.irfft(np.conj(np.fft.rfft(a, n)) * np.fft.rfft(b, n), n)
    return int(np.argmax(corr[:max_lag]))


def seg_snr(ref: np.ndarray, dec: np.ndarray, frame: int = 882,
            clamp=(-10.0, 35.0)) -> tuple[float, float]:
    """(segmental SNR dB, plain PSNR dB) over the aligned overlap.

    Segmental SNR: mean over 20 ms frames of the per-frame SNR clamped
    to [-10, 35] dB (the standard speech/audio definition — the clamp
    stops one silent or one pathological frame from dominating), with
    frames whose signal RMS is < 1e-4 skipped as silence.
    """
    d = align_lag(ref, dec)
    m = min(len(ref), len(dec) - d) - 2048
    r = ref[1024:m]
    x = dec[d + 1024:d + m]
    err = x - r
    nfr = len(r) // frame
    es = (r[: nfr * frame] ** 2).reshape(nfr, -1).mean(1)
    ee = (err[: nfr * frame] ** 2).reshape(nfr, -1).mean(1)
    keep = es > 1e-8
    s = 10 * np.log10(np.maximum(es[keep], 1e-30) / np.maximum(ee[keep], 1e-30))
    seg = float(np.clip(s, *clamp).mean())
    psnr = float(10 * np.log10(1.0 / max(float((err ** 2).mean()), 1e-30)))
    return seg, psnr


def nmr_exceedance(src: np.ndarray, dec: np.ndarray) -> float:
    """Mean positive log noise-to-mask ratio (dB) over (granule,
    partition) cells: how much quantization noise pokes ABOVE the
    psymodel's masking threshold. This is the quantity PM2's outer loop
    minimizes, so it is the right axis for the PM2-on-vs-off payoff
    (plain SNR moves the OTHER way by design: shaping spends noise
    where it is masked). Self-referee caveat: the mask comes from our
    own PM2 on the SOURCE — fine for an A/B of two mp3tpu configs fed
    identical thresholds, not a cross-encoder metric.

    src/dec sample-aligned (our decode_file output is gapless)."""
    from mp3tpu.encoder.psymodel import NFFT_L, get_model
    m = get_model(SR)
    x = src[:, 0] if src.ndim > 1 else src
    y = dec[:, 0] if dec.ndim > 1 else dec
    n = min(len(x), len(y))
    G = n // 576
    nb = m.analyze(x[: G * 576], np.zeros(G, np.int64)).nb_l  # [G, np_l]
    err = (y - x)[: G * 576]
    win = np.hanning(NFFT_L)
    pad = np.zeros(NFFT_L)
    e = np.concatenate([pad, err, pad])
    starts = np.arange(G) * 576 - (NFFT_L - 576) // 2 + NFFT_L
    fr = e[starts[:, None] + np.arange(NFFT_L)[None]] * win
    eb_noise = (np.abs(np.fft.rfft(fr, axis=1)) ** 2) @ m.red_l
    act = nb > 1e-10                      # cells with a meaningful mask
    nmr_db = 10.0 * np.log10(np.maximum(eb_noise[act], 1e-30)
                             / nb[act])
    return float(np.maximum(nmr_db, 0.0).mean())


# ------------------------------------------------------------------ runner

def run(seconds: float = 3.0, fixtures=None, bitrate: int = BITRATE) -> dict:
    """Encode/decode/score every fixture; returns {fixture: {enc: (seg, psnr)}}."""
    import lameref
    import mpg123ref
    from mp3tpu.encoder import encode_pcm

    out = {}
    for name in (fixtures or FIXTURES):
        sig = FIXTURES[name](seconds)
        streams = {
            "mp3tpu_pm2": encode_pcm(sig, SR, bitrate=bitrate,
                                     noise_shaping=True),
            "mp3tpu_nops": encode_pcm(sig, SR, bitrate=bitrate,
                                      noise_shaping=False),
            "lame": lameref.encode(sig, SR, bitrate=bitrate, quality=2),
        }
        out[name] = {}
        for enc, mp3 in streams.items():
            pcm, rate = mpg123ref.decode(mp3)
            assert rate == SR
            if pcm.shape[1] == 1:
                pcm = np.repeat(pcm, 2, 1)
            seg, psnr = seg_snr(sig, pcm.astype(np.float64))
            out[name][enc] = {"seg_snr_db": round(seg, 2),
                              "psnr_db": round(psnr, 2),
                              "bytes": len(mp3)}
    return out


def main():
    res = run()
    hdr = f"{'fixture':<10} {'mp3tpu PM2':>14} {'mp3tpu noPS':>14} {'LAME q2':>14}"
    print(hdr)
    print("-" * len(hdr))
    for name, row in res.items():
        cells = [f"{row[e]['seg_snr_db']:.1f}/{row[e]['psnr_db']:.1f}"
                 for e in ("mp3tpu_pm2", "mp3tpu_nops", "lame")]
        print(f"{name:<10} {cells[0]:>14} {cells[1]:>14} {cells[2]:>14}")
    print("(cells: segmental SNR dB / plain PSNR dB, via libmpg123)")

    # PM2 payoff on its own axis: noise-to-mask exceedance (plain SNR
    # moves the other way by design — shaping spends noise where the
    # model says it is masked)
    from mp3tpu.encoder import encode_pcm
    from mp3tpu.pipeline import decode_file
    nmr = {}
    for name in ("transient", "chirpmix"):
        sig = FIXTURES[name](3.0)
        nmr[name] = {}
        for key, ns in (("pm2", True), ("nops", False)):
            mp3 = encode_pcm(sig, SR, bitrate=BITRATE, noise_shaping=ns)
            pcm, _ = decode_file(mp3, output="float32")
            nmr[name][key] = round(
                nmr_exceedance(sig, pcm.astype(np.float64)), 3)
        print(f"NMR+ {name}: PM2 {nmr[name]['pm2']} dB vs "
              f"off {nmr[name]['nops']} dB (lower = better shaped)")
    print(json.dumps({"quality_128k": res, "nmr_exceedance_db": nmr}))


if __name__ == "__main__":
    # the referee comparison runs the host encode reference: keep it
    # on the CPU backend unless JAX_PLATFORMS says otherwise
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
