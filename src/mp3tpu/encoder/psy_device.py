"""Device psychoacoustic model 2 (SURVEY.md E3, §3.4).

Batched jnp port of psymodel.PsyModel.analyze: one jitted call maps
[B, n] PCM onto per-granule threshold/energy ratios for a whole batch
of channels — the FFT analysis is embarrassingly parallel over
granules, exactly the shape an accelerator wants. Tables come from the
SAME PsyModel instance (single source of truth); the numpy model stays
the reference (device output is f32-close, asserted by tests, and only
shapes the outer loop's allowed-distortion targets).

Short-window analysis runs for ALL granules (fixed shapes; the ~3x256
FFT per granule is trivial next to the long path) and the host masks
non-short granules to the "unused" sentinel, mirroring the reference.
"""
from __future__ import annotations

import functools

import numpy as np

from .psymodel import (NFFT_L, NFFT_S, NMT_DB, RPELEV1, RPELEV2, SNR_S_DB,
                       SPF, TMN_DB, get_model)


@functools.lru_cache(maxsize=None)
def _jitted(sample_rate: int, G: int, align: int = 0):
    """align > 0 analyzes a copy of the signal delayed by that many
    samples (psymodel.MDCT_ALIGN) WITHOUT materializing it: the
    analysis-frame gather indices shift back instead, so the staged
    device PCM is shared with the MDCT (which must see the unshifted
    signal). Equivalent to analyze(align_to_mdct(pcm)) up to the
    zero-fill at the start (asserted by tests)."""
    import jax
    import jax.numpy as jnp
    m = get_model(sample_rate)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    # every band/spreading product in float32 (never TF32)
    mm = functools.partial(jnp.matmul, precision="highest")
    red_l, spread_l = f32(m.red_l), f32(m.spread_l)
    red_s, spread_s = f32(m.red_s), f32(m.spread_s)
    minval_l = f32(m.minval_l)
    qthr_l, qthr_s = f32(m.qthr_l), f32(m.qthr_s)
    w_l = f32(m.w_l)
    w_s12 = f32(m.w_s[:, :12])
    win_l, win_s = f32(m.win_l), f32(m.win_s)

    # analysis-frame gather indices (host-precomputed, shared across B);
    # both paths pad by NFFT_L so an aligned (shifted-back) start stays
    # in range: min start = -(NFFT_L-SPF)//2 - align = -752 > -1024
    g = np.arange(G)
    starts_l = g * SPF - (NFFT_L - SPF) // 2 - align
    idx_l = jnp.asarray(starts_l[:, None] + NFFT_L + np.arange(NFFT_L)[None])
    sg = np.repeat(g, 3)
    wv = np.tile(np.arange(3), G)
    starts_s = sg * SPF + wv * 192 - (NFFT_S - 192) // 2 - align
    idx_s = jnp.asarray(starts_s[:, None] + NFFT_L + np.arange(NFFT_S)[None])

    @jax.jit
    def run(pcm):
        """pcm f32 [B, G*576] -> (ratio_l [B,G,21], ratio_s [B,G,3,12])."""
        B = pcm.shape[0]
        pad = jnp.zeros((B, NFFT_L), jnp.float32)
        x = jnp.concatenate([pad, pcm, pad], axis=1)
        fr = x[:, idx_l] * win_l                     # [B, G, 1024]
        spec = jnp.fft.rfft(fr, axis=2)
        r = jnp.abs(spec)
        f = jnp.angle(spec)
        z = jnp.zeros((B, 1) + r.shape[2:], r.dtype)
        r1 = jnp.concatenate([z, r[:, :-1]], axis=1)
        r2 = jnp.concatenate([z, z, r[:, :-2]], axis=1)
        f1 = jnp.concatenate([z, f[:, :-1]], axis=1)
        f2 = jnp.concatenate([z, z, f[:, :-2]], axis=1)
        rp = 2.0 * r1 - r2
        fp = 2.0 * f1 - f2
        num = jnp.sqrt((r * jnp.cos(f) - rp * jnp.cos(fp)) ** 2
                       + (r * jnp.sin(f) - rp * jnp.sin(fp)) ** 2)
        c = num / jnp.maximum(r + jnp.abs(rp), 1e-30)
        e_bin = r * r
        eb = mm(e_bin, red_l)
        cb = mm(c * e_bin, red_l)
        ecb = mm(eb, spread_l.T)
        ct = mm(cb, spread_l.T)
        cbn = jnp.clip(ct / jnp.maximum(ecb, 1e-30), 0.05, 1.0)
        tb = jnp.clip(-0.299 - 0.43 * jnp.log(cbn), 0.0, 1.0)
        snr_db = jnp.maximum(minval_l[None, None],
                             tb * TMN_DB + (1.0 - tb) * NMT_DB)
        nb = ecb * 10.0 ** (-snr_db / 10.0)
        inf = jnp.full_like(nb[:, :1], jnp.inf)
        nb1 = jnp.concatenate([inf, nb[:, :-1]], axis=1)
        nb2 = jnp.concatenate([inf, inf, nb[:, :-2]], axis=1)
        nb = jnp.minimum(nb, jnp.minimum(RPELEV1 * nb1, RPELEV2 * nb2))
        nb = jnp.maximum(nb, qthr_l[None, None])
        thm_sfb = mm(nb, w_l)
        en_sfb = mm(eb, w_l)
        ratio_l = thm_sfb / jnp.maximum(en_sfb, 1e-30)

        # short path for every granule (host masks non-short); shares
        # the long path's NFFT_L-padded signal (aligned starts need it)
        frs = x[:, idx_s] * win_s                    # [B, 3G, 256]
        es = jnp.abs(jnp.fft.rfft(frs, axis=2)) ** 2
        ebs = mm(es, red_s)                          # [B, 3G, np_s]
        ecbs = mm(ebs, spread_s.T)
        nbs = (ecbs * 10.0 ** (-SNR_S_DB / 10.0)).reshape(B, G, 3, -1)
        nbs = nbs.at[:, :, 1].min(RPELEV1 * nbs[:, :, 0])
        nbs = nbs.at[:, :, 2].min(RPELEV1 * nbs[:, :, 1])
        nbs = jnp.maximum(nbs, qthr_s[None, None, None])
        thm_s = mm(nbs, w_s12)
        en_s = mm(ebs.reshape(B, G, 3, -1), w_s12)
        ratio_s = thm_s / jnp.maximum(en_s, 1e-30)
        return ratio_l, ratio_s

    return run


def analyze_batch(pcm: np.ndarray, block_types: np.ndarray,
                  sample_rate: int, align: int = 0):
    """pcm [B, G*576] (channels as rows), block_types [B, G].

    Returns (ratio_l [B,G,21] f64, ratio_s [B,G,3,12] f64) with the
    non-short granules' ratio_s at the reference's unused sentinel.
    align: see _jitted (pass psymodel.MDCT_ALIGN when pcm is the raw
    signal rather than an already-delayed copy)."""
    import jax.numpy as jnp
    B, n = pcm.shape
    G = n // SPF
    rl, rs = _jitted(sample_rate, G, align)(jnp.asarray(pcm, jnp.float32))
    rl = np.asarray(rl, np.float64)
    rs = np.asarray(rs, np.float64)
    rs[block_types != 2] = 1e9
    return rl, rs


def analyze_batch_handle(pcm_dev, G: int, sample_rate: int,
                         align: int = 0):
    """As analyze_batch but takes a STAGED device pcm [B, G*576] f32
    and returns DEVICE ratio handles (the batch encoder combines them
    with band energies into xmin rows without a host round-trip).
    Non-short masking happens downstream on device."""
    return _jitted(sample_rate, G, align)(pcm_dev)
