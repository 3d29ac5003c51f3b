"""Device encoder transform — E1+E2 as batched JAX (SURVEY.md §3.4:
analysis filterbank + MDCT run on device; quantization loops and Huffman
coding stay on host).

Maps a whole batch of PCM onto spectra in one jitted call: the analysis
polyphase bank is the same 16-tap FIR over 32-sample blocks as the host
version (one constant matmul stack), the MDCT is a [36->18] windowed
constant matmul per block type, alias/reorder are the decoder matrices'
transposes. Matches the numpy transform to float32 accuracy (tested).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST
SPF = 576


@functools.lru_cache(maxsize=None)
def _consts(sample_rate: int):
    from ..tables import maps as tmaps
    from . import filterbank as efb
    A = efb.analysis_fir()                      # [16, 32, 32]
    fmats = efb.mdct_matrices()                 # [4, 36, 18]
    alias_f = efb.forward_alias_matrices()      # [3, 576, 576]
    _bm, rm = tmaps.get_maps(sample_rate)
    # inverse reorder as permutation matrices composed with alias
    post = np.zeros((4, 576, 576))
    for bt in range(4):
        flavor = 1 if bt == 2 else 0
        perm = rm[flavor]
        Pinv = np.zeros((576, 576))
        Pinv[np.arange(576), perm] = 1.0        # t[:, perm] = y
        post[bt] = alias_f[flavor] @ Pinv
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return f32(A), f32(fmats), f32(post), f32(inv)


@functools.lru_cache(maxsize=None)
def _jitted(sample_rate: int):
    A, fmats, post, inv = _consts(sample_rate)

    @jax.jit
    def run(pcm, bt_oh):
        """pcm f32 [B, n] (n multiple of 576); bt_oh f32 [B, G, 4] one-hot
        block types -> xr f32 [B, G, 576] transmitted-order spectra."""
        B, n = pcm.shape
        G = n // SPF
        P = pcm.reshape(B, n // 32, 32)
        T = P.shape[1]
        Ppad = jnp.concatenate([jnp.zeros((B, 15, 32), jnp.float32), P], axis=1)
        h = jnp.stack([Ppad[:, 15 - d: 15 - d + T] for d in range(16)],
                      axis=2)                   # [B, T, 16, 32]
        S = jnp.einsum("btdk,dkj->btj", h, A, precision=HIGHEST)  # [B, T, 32]
        Sg = S.reshape(B, G, 18, 32).transpose(0, 1, 3, 2) * inv  # [B,G,32,18]
        prev = jnp.concatenate([jnp.zeros((B, 1, 32, 18), jnp.float32),
                                Sg[:, :-1]], axis=1)
        wide = jnp.concatenate([prev, Sg], axis=3)                # [B,G,32,36]
        X = jnp.einsum("bgsj,fjk,bgf->bgsk", wide, fmats, bt_oh,
                       precision=HIGHEST)                         # [B,G,32,18]
        nat = X.reshape(B, G, 576)
        out = jnp.einsum("bgi,fij,bgf->bgj", nat, post, bt_oh,
                         precision=HIGHEST)
        return out

    return run


def granule_spectra_device(pcm: np.ndarray, block_types: np.ndarray,
                           sample_rate: int) -> np.ndarray:
    """Device counterpart of transform.granule_spectra for one channel;
    also accepts [B, n] batches via granule_spectra_device_batch."""
    out = granule_spectra_device_batch(pcm[None], block_types[None], sample_rate)
    return out[0]


def granule_spectra_device_batch(pcm: np.ndarray, block_types: np.ndarray,
                                 sample_rate: int) -> np.ndarray:
    B, n = pcm.shape
    G = n // SPF
    bt_oh = (block_types[..., None] == np.arange(4)).astype(np.float32)
    xr = _jitted(sample_rate)(jnp.asarray(pcm[:, : G * SPF], jnp.float32),
                              jnp.asarray(bt_oh))
    return np.asarray(xr).astype(np.float64)


def stage_chunked(arr: np.ndarray, piece_bytes: int = 2 << 20):
    """Stage a host array to device in <=2 MB pieces along axis 0 +
    one device-side concatenate (a layout kept from an earlier
    host link; whether the split pays on the GPU is not measured)."""
    import jax
    arr = np.ascontiguousarray(arr)
    row_b = max(arr.nbytes // max(arr.shape[0], 1), 1)
    rows = max(piece_bytes // row_b, 1)
    if arr.shape[0] <= rows:
        return jax.device_put(arr)
    parts = [jax.device_put(arr[i:i + rows])
             for i in range(0, arr.shape[0], rows)]
    return jnp.concatenate(parts, axis=0)


FORCE_F32_STAGE = False  # test hook: pin the f32 staging path


@functools.lru_cache(maxsize=None)
def _dequant_i16_jit():
    @jax.jit
    def f(v):
        return v.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
    return f


def stage_pcm(pcm_b: np.ndarray):
    """Stage encoder input PCM [B, n] f32, shipping int16 when every
    sample is int16-origin (k/32768 with k in range — WAV files and
    decoder output, i.e. almost all real encoder input): HALF the H2D
    bytes, and k/2^15 dequantized on device is exact in f32, so the
    encode is bit-identical to f32 staging (tested). Returns
    (pcm_dev, staged_int16)."""
    if FORCE_F32_STAGE:
        return stage_chunked(pcm_b), False
    rows = max(1, (4 << 20) // max(pcm_b.shape[1] * 4, 1))
    i16 = np.empty(pcm_b.shape, np.int16)
    for lo in range(0, pcm_b.shape[0], rows):
        x = pcm_b[lo:lo + rows] * np.float32(32768.0)
        if not (np.array_equal(x, np.rint(x))
                and (x >= -32768.0).all() and (x <= 32767.0).all()):
            return stage_chunked(pcm_b), False
        i16[lo:lo + rows] = x.astype(np.int16)
    return _dequant_i16_jit()(stage_chunked(i16)), True


@functools.lru_cache(maxsize=None)
def _gather_rows_jit(T: int, nch: int):
    """Device-resident encode input (SURVEY.md §3.2 chained the other
    way): pull trimmed, zero-padded, dequantized stream rows straight
    out of a DecodedBatch int16 chunk — the PCM never crosses the
    host boundary between decode and encode (transcode path)."""
    @jax.jit
    def g(chunk_i16, rows, skips, lens):
        """chunk int16 [S, n, C]; rows/skips/lens int32 [K] ->
        f32 [K, nch, T]: stream k's [skips[k], skips[k]+lens[k]) PCM,
        dequantized k/2^15 (exact in f32 — identical to stage_pcm's
        int16-origin staging), zero-padded to T."""
        j = jnp.arange(T, dtype=jnp.int32)
        n = chunk_i16.shape[1]
        idx = jnp.minimum(skips[:, None] + j[None], jnp.int32(n - 1))
        sel = jnp.take(chunk_i16, rows, axis=0)               # [K, n, C]
        x = jnp.take_along_axis(sel, idx[:, :, None], axis=1)  # [K, T, C]
        x = jnp.where(j[None, :, None] < lens[:, None, None], x,
                      jnp.int16(0))
        out = x.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
        return out[:, :, :nch].transpose(0, 2, 1)             # [K, nch, T]
    return g


@functools.lru_cache(maxsize=None)
def _subblock_energy_jit(align: int):
    """64-sample sub-block energies of the high-passed channel mean —
    block_type_sequence's reduction half, on device (the decision half
    stays host: psymodel.block_types_from_subblock_energy). `align`
    applies align_to_mdct's delay inside the same dispatch."""
    @jax.jit
    def f(pcm_bnt):
        """f32 [B, nch, T] (T % 64 == 0) -> e f32 [B, T//64]."""
        x = jnp.mean(pcm_bnt, axis=1)                          # [B, T]
        T = x.shape[1]
        x = jnp.pad(x, ((0, 0), (align, 0)))[:, :T]
        hp = x - jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)
        return jnp.sum(hp.reshape(x.shape[0], T // 64, 64) ** 2, axis=2)
    return f


def granule_spectra_device_handle(pcm_dev, block_types: np.ndarray,
                                  sample_rate: int):
    """As granule_spectra_device_batch but takes an ALREADY-STAGED
    device pcm [B, n] f32 and returns the DEVICE spectra handle
    [B, G, 576] f32 (no host round-trip — the batch encoder keeps the
    spectra device-resident through the rate loops)."""
    bt_oh = (block_types[..., None] == np.arange(4)).astype(np.float32)
    return _jitted(sample_rate)(pcm_dev, jnp.asarray(bt_oh))
