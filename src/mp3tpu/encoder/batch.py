"""Batched multi-stream encoder (SURVEY.md §3.4, BASELINE config 5).

encode_batch() is the encoder's aggregate-throughput path: many
streams encode together, and the spectra stay DEVICE-RESIDENT from the
analysis transform through the rate loops — the host sees only small
control tensors plus the final quantized spectra:

  stage PCM            once (int16 when the input is int16-origin)
  E1+E2 transform      device jit -> device handle [B*nch, G, 576]
  E3 psymodel 2        device jit on the SAME staged pcm
  MS decision + xmin   device jits (energies down, masks up — KBs)
  E4 rate/distortion   device dispatches per block-type group, rows
                       GATHERED on device (vloop_device.*_gathered);
                       the device's final f32 quantize IS the emitted
                       spectrum and its integer bit count / table
                       selection is exact for it (count == emit)
  reservoir control    host per stream (two-pass deterministic walk,
                       same policy as encode_pcm — SURVEY.md §7.5-5
                       keeps loop CONTROL on host)
  E5/E6 emission       native C++ row emitter (bit-for-bit the Python
                       encode_granule) + packed mux (mux_packed)

The single-stream encode_pcm (numpy lockstep, f64 scalar-exact) is the
reference; encode_batch's device search differs from it only by
±half-step rounding at f32 quantization boundaries (still a valid
quantizer) while honoring the same budget/reservoir contracts: every
granule's EXACT coded size is known before mux, and a per-frame
overdraft guard refits against the true reservoir. Streams must share
sample_rate/channel count; mixed batches fall back to encode_pcm.
"""
from __future__ import annotations

import functools

import numpy as np

from ..container.frames import BITRATES_V1_L3
from . import vloop, vloop_device
from .huffcode import encode_granule
from .mux import FrameSizer, ReservoirMux, build_xing_frame, \
    frame_capacity_bits
from .psymodel import MDCT_ALIGN, align_to_mdct, block_type_sequence
from ..tables.sfb import LONG
from . import ENCODER_DELAY, SPF, SR_IDX, _short_flat_map

S2 = 1.0 / np.sqrt(2.0)

# last MP3TPU_ENCODE_PROFILE=1 phase walls (tools/encode_single_profile.py)
LAST_PROFILE: dict = {}


@functools.lru_cache(maxsize=None)
def _prep_jits(sample_rate: int, nch: int):
    import jax
    import jax.numpy as jnp
    bands = LONG[sample_rate]
    ind21 = np.zeros((576, 21), np.float32)
    for b in range(21):
        ind21[bands[b]:bands[b + 1], b] = 1.0
    flat = _short_flat_map(sample_rate)
    ind39 = np.zeros((576, 39), np.float32)
    ind39[np.arange(576), np.minimum(flat, 38)] = 1.0
    j21 = jnp.asarray(ind21)
    j39 = jnp.asarray(ind39)

    @jax.jit
    def energies(X):
        """X [B*nch, G, 576] -> per-granule channel energies and (for
        stereo) mid/side energies for the frame MS decision."""
        Bn, G, _ = X.shape
        X2 = X.reshape(Bn // nch, nch, G, 576)
        e_gc = jnp.sum(X2 * X2, axis=3)                    # [B, nch, G]
        if nch == 2:
            mid = (X2[:, 0] + X2[:, 1]) * S2
            side = (X2[:, 0] - X2[:, 1]) * S2
            e_m = jnp.sum(mid * mid, axis=2)               # [B, G]
            e_s = jnp.sum(side * side, axis=2)
        else:
            e_m = e_s = jnp.zeros((Bn // nch, G), jnp.float32)
        return e_m, e_s, e_gc

    @jax.jit
    def prep(X, msg, ratio_l, ratio_s, short_row):
        """Apply mid/side on flagged granules and build the loop
        inputs, all device-resident.

        X [B*nch, G, 576]; msg [B, G] bool; ratio_l [B*nch, G, 21];
        ratio_s [B*nch, G, 3, 12]; short_row [B*G*nch] bool.
        Returns rows [B*G*nch, 576], xmin_l [., 21], xmin_s [., 3, 12]
        (row id = (b*G + g)*nch + c)."""
        Bn, G, _ = X.shape
        B = Bn // nch
        X2 = X.reshape(B, nch, G, 576)
        rl = ratio_l.reshape(B, nch, G, 21)
        rs = ratio_s.reshape(B, nch, G, 3, 12)
        if nch == 2:
            mid = (X2[:, 0] + X2[:, 1]) * S2
            side = (X2[:, 0] - X2[:, 1]) * S2
            m = msg[:, None, :, None]
            X2 = jnp.where(m, jnp.stack([mid, side], 1), X2)
            both_l = jnp.minimum(rl[:, 0], rl[:, 1])[:, None]
            both_s = jnp.minimum(rs[:, 0], rs[:, 1])[:, None]
            rl = jnp.where(m, both_l, rl)
            rs = jnp.where(msg[:, None, :, None, None], both_s, rs)
        rows = X2.transpose(0, 2, 1, 3).reshape(-1, 576)
        rl_rows = rl.transpose(0, 2, 1, 3).reshape(-1, 21)
        rs_rows = rs.transpose(0, 2, 1, 3, 4).reshape(-1, 3, 12)
        rs_rows = jnp.where(short_row[:, None, None], rs_rows, 1e9)
        p2 = rows * rows
        en_l = jnp.matmul(p2, j21, precision="highest")
        en_s = jnp.matmul(p2, j39, precision="highest").reshape(
            -1, 3, 13)[:, :, :12]
        return rows, rl_rows * en_l, rs_rows * en_s

    return energies, prep


def encode_batch(pcms, sample_rate: int | None = None,
                 bitrate: int | None = None,
                 gapless_tag: bool | None = None,
                 short_blocks: bool | None = None,
                 joint_stereo: bool | None = None,
                 noise_shaping: bool | None = None,
                 reservoir: bool = True, mesh=None) -> list[bytes]:
    """Encode a batch of float PCM arrays ([n] or [n, ch], same channel
    count and sample rate) to MP3 bytes. See module docstring.

    pcms may also be a DecodedBatch handle (decode_batch(...,
    output="device")): the device-resident transcode path. The int16
    PCM is trimmed/dequantized/padded IN HBM (one gather dispatch per
    decode chunk) and block-type labels come from a device sub-block
    energy reduction — no staging H2D and no decode D2H. sample_rate
    is inferred from the handle (must be uniform). Output is
    bit-identical to encoding the handle's .numpy() PCM, except that
    transient labels derive from f32 device energies instead of f64
    host energies (same decision logic, ULP-level input difference).
    Host-fallback records, mixed channel counts, and mesh mode
    materialize to the host path (correct, not zero-copy).

    Unset parameters fall back to the active EncodeConfig (SURVEY.md
    §5.6), mirroring encode_pcm.

    mesh: an optional 1-D jax Mesh ("streams" axis — SURVEY.md §2.4
    P2): the staged PCM is placed stream-sharded and every device
    stage (transforms, psymodel, rate loops) runs SPMD over the mesh;
    streams are independent, so the only cross-device traffic is the
    row gathers the loop dispatches perform. Output bytes are
    identical to the single-device path (tested on the 8-device CPU
    mesh)."""
    from ..config import get_active
    ecfg = get_active().encode
    bitrate = ecfg.bitrate if bitrate is None else bitrate
    gapless_tag = ecfg.gapless_tag if gapless_tag is None else gapless_tag
    short_blocks = ecfg.short_blocks if short_blocks is None else short_blocks
    joint_stereo = ecfg.joint_stereo if joint_stereo is None else joint_stereo
    noise_shaping = (ecfg.noise_shaping if noise_shaping is None
                     else noise_shaping)
    if bitrate not in BITRATES_V1_L3:
        raise ValueError("unsupported bitrate")
    is_dev_batch = (hasattr(pcms, "device_pcm")
                    and hasattr(pcms, "sample_rates"))
    if not is_dev_batch and sample_rate not in SR_IDX:
        raise ValueError("unsupported sample rate")
    import os
    import time
    import jax.numpy as jnp
    _prof = os.environ.get("MP3TPU_ENCODE_PROFILE") == "1"
    _t0 = time.perf_counter()
    _ph: dict = {}

    def _mark(name):
        # phase walls (downloads inside each phase act as sync points)
        nonlocal _t0
        if _prof:
            t = time.perf_counter()
            _ph[name] = _ph.get(name, 0.0) + t - _t0
            _t0 = t
    # ---- device-resident input (DecodedBatch, SURVEY.md §3.2) -----------
    # transcode path: decode_batch(output="device") -> encode_batch —
    # the PCM never crosses the host boundary (no stage H2D, no decode
    # D2H). Host-fallback records / mixed channels / mesh materialize
    # to the host path below (correct, just not zero-copy).
    dev_batch = pcms if is_dev_batch else None
    recs = None
    if dev_batch is not None:
        rates = set(dev_batch.sample_rates)
        if len(rates) != 1:
            raise ValueError("device-batch encode needs one sample rate, "
                             f"got {sorted(rates)}")
        rate = rates.pop()
        if sample_rate is not None and sample_rate != rate:
            raise ValueError(f"sample_rate {sample_rate} != decoded {rate}")
        sample_rate = rate
        if sample_rate not in SR_IDX:
            raise ValueError("unsupported decoded sample rate")
        recs = [dev_batch.device_pcm(i) for i in range(len(dev_batch))]
        nchs = {r[4] for r in recs}
        if (mesh is not None or len(nchs) != 1 or next(iter(nchs)) > 2
                or any(isinstance(r[0], np.ndarray) for r in recs)):
            pcms = [p.astype(np.float64) / 32768.0
                    for p, _sr in dev_batch.numpy()]
            dev_batch, recs = None, None

    arrs = []
    if dev_batch is None:
        for p in pcms:
            a = np.asarray(p, np.float64)
            if a.ndim == 1:
                a = a[:, None]
            arrs.append(a)
        nchs = {a.shape[1] for a in arrs}
        if len(nchs) != 1 or arrs[0].shape[1] > 2:
            from . import encode_pcm
            return [encode_pcm(a, sample_rate, bitrate=bitrate,
                               gapless_tag=gapless_tag,
                               short_blocks=short_blocks,
                               joint_stereo=joint_stereo,
                               noise_shaping=noise_shaping,
                               reservoir=reservoir) for a in arrs]
        nch = arrs[0].shape[1]
        B = len(arrs)
    else:
        nch = recs[0][4]
        B = len(recs)
    sr_idx = SR_IDX[sample_rate]
    br_idx = BITRATES_V1_L3.index(bitrate)

    # ---- per-stream padding / block types -------------------------------
    G_s, pad_s, bts_s, encpad_s = [], [], [], []
    ns = ([len(a) for a in arrs] if dev_batch is None
          else [int(r[3] - r[2]) for r in recs])
    for s, n in enumerate(ns):
        total_needed = n + ENCODER_DELAY + 529
        G = -(-total_needed // SPF)
        G += G & 1
        G_s.append(G)
        encpad_s.append(G * SPF - ENCODER_DELAY - n)
        if dev_batch is not None:
            continue  # PCM stays on device; labels after the gather
        a = arrs[s]
        padded = np.zeros((G * SPF, nch))
        padded[:n] = a
        pad_s.append(padded)
        # labels are computed AFTER the staging puts are issued (below),
        # so the transfers run while this host thread labels
    Gmax = max(G_s)
    _mark('host_prep')

    # ---- stage once; transform + psymodel on device ---------------------
    from .device import granule_spectra_device_handle, stage_pcm
    Bn = B * nch
    Bpad = 1 << max(Bn - 1, 0).bit_length()
    if mesh is not None:  # stream axis must split evenly over the mesh
        d = int(mesh.devices.size)
        Bpad = -(-Bpad // d) * d
    Gpad = -(-Gmax // 64) * 64
    if dev_batch is not None:
        # one gather dispatch per run of streams sharing a decode chunk:
        # trim + dequantize + zero-pad in-HBM (device._gather_rows_jit)
        from .device import _gather_rows_jit, _subblock_energy_jit
        T = Gpad * SPF
        blocks = []
        i = 0
        while i < B:
            chunk = recs[i][0]
            k = i
            while k < B and recs[k][0] is chunk:
                k += 1
            blocks.append(_gather_rows_jit(T, nch)(
                chunk,
                jnp.asarray(np.array([recs[t][1] for t in range(i, k)],
                                     np.int32)),
                jnp.asarray(np.array([recs[t][2] for t in range(i, k)],
                                     np.int32)),
                jnp.asarray(np.array(ns[i:k], np.int32))))
            i = k
        pcm_bnt = blocks[0] if len(blocks) == 1 else \
            jnp.concatenate(blocks, axis=0)                 # [B, nch, T]
        if short_blocks:
            # reduction on device, decision on host — same semantics as
            # the host path (shared block_types_from_subblock_energy);
            # energies are f32 here vs f64 there (ULP-level, tested)
            from .psymodel import block_types_from_subblock_energy
            e = np.asarray(_subblock_energy_jit(MDCT_ALIGN)(pcm_bnt),
                           np.float64)                      # [B, T//64]
            bts_s = [block_types_from_subblock_energy(e[s, : G_s[s] * 9])
                     for s in range(B)]
        else:
            bts_s = [np.zeros(G, np.int64) for G in G_s]
        pcm_dev = jnp.pad(pcm_bnt.reshape(B * nch, T),
                          ((0, Bpad - B * nch), (0, 0)))
        staged_i16 = True
    else:
        pcm_b = np.zeros((Bpad, Gpad * SPF), np.float32)
        for s in range(B):
            for c in range(nch):
                pcm_b[s * nch + c, : G_s[s] * SPF] = pad_s[s][:, c]
        pcm_dev, staged_i16 = stage_pcm(pcm_b)
        if mesh is not None:
            # P2 sharding seam: place the staged PCM stream-sharded;
            # every downstream jit (transform/psymodel/prep/loops)
            # compiles SPMD from the input sharding (compute follows
            # data)
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            pcm_dev = jax.device_put(pcm_dev,
                                     NamedSharding(mesh, P("streams")))
        # block-type labels on the MDCT-aligned copy (psymodel.MDCT_ALIGN:
        # granule g's spectrum holds time content delayed by the analysis
        # chain, so unshifted labels switch one granule early) — computed
        # HERE, after the staging puts are enqueued, so this host work
        # rides inside the H2D flight window instead of serializing
        # before it
        bts_s = [block_type_sequence(align_to_mdct(pad_s[s]), sample_rate)
                 if short_blocks else np.zeros(G_s[s], np.int64)
                 for s in range(B)]
    bts_b = np.zeros((Bpad, Gpad), np.int64)
    for s in range(B):
        for c in range(nch):
            bts_b[s * nch + c, : G_s[s]] = bts_s[s]
    if _prof:
        _ph['stage_int16'] = int(staged_i16)
    _mark('stage')
    X = granule_spectra_device_handle(pcm_dev, bts_b, sample_rate)
    if noise_shaping:
        from .psy_device import analyze_batch_handle
        # align: the staged pcm is unshifted (the MDCT shares it); the
        # psymodel's gather windows shift back by MDCT_ALIGN instead
        rl_dev, rs_dev = analyze_batch_handle(pcm_dev, Gpad, sample_rate,
                                              align=MDCT_ALIGN)
    else:
        rl_dev = jnp.zeros((Bpad, Gpad, 21), jnp.float32)
        rs_dev = jnp.zeros((Bpad, Gpad, 3, 12), jnp.float32)
    _mark('transform_psy_dispatch')

    # ---- MS decision from device energies -------------------------------
    energies, prep = _prep_jits(sample_rate, nch)
    e_m, e_s, e_gc = energies(X)
    e_m = np.asarray(e_m)
    e_s = np.asarray(e_s)
    e_gc = np.asarray(e_gc, np.float64)                    # [B', nch, G]
    _mark('energies_download')
    ms_s = []
    msg_b = np.zeros((Bpad // nch if nch == 2 else Bpad, Gpad), bool)
    for s in range(B):
        n_frames = G_s[s] // 2
        ms_f = np.zeros(n_frames, bool)
        if nch == 2 and joint_stereo:
            em = e_m[s, : G_s[s]].reshape(n_frames, 2).sum(1)
            es = e_s[s, : G_s[s]].reshape(n_frames, 2).sum(1)
            ms_f = es < 0.5 * em
            msg_b[s, : G_s[s]] = np.repeat(ms_f, 2)
        ms_s.append(ms_f)

    # ---- device prep: MS butterfly + xmin rows (stay on device) ---------
    # row id in the padded layout: (b*Gpad + g)*nch + c
    bt_pad = np.zeros((Bpad // nch if nch else Bpad, Gpad, nch), np.int64)
    for s in range(B):
        bt_pad[s, : G_s[s]] = bts_s[s][:, None]
    short_row = (bt_pad.reshape(-1) == 2)
    rows_dev, xminl_dev, xmins_dev = prep(
        X, jnp.asarray(msg_b), rl_dev, rs_dev, jnp.asarray(short_row))
    _mark('prep_dispatch')

    # valid-row ids (skips pad streams/granules), aligned with the
    # frame-major gc order the mux consumes
    vid_parts = []
    for s in range(B):
        g = np.arange(G_s[s])
        vid_parts.append(((s * Gpad + g)[:, None] * nch
                          + np.arange(nch)).ravel())
    vid = np.concatenate(vid_parts)
    offs = np.cumsum([0] + [G_s[s] * nch for s in range(B)])
    n_gc = int(offs[-1])
    bt_all = np.concatenate([np.repeat(bts_s[s], nch) for s in range(B)])

    # ---- pass-A budgets: per-stream pessimistic reservoir walk ----------
    cap_s, base_s, loud_s, feed_s, granted_s = [], [], [], [], []
    for s in range(B):
        n_frames = G_s[s] // 2
        sizer = FrameSizer(sample_rate, bitrate * 1000)
        fsizes = [sizer.next() for _ in range(n_frames)]
        cap_f = np.array([frame_capacity_bits(fb, nch) for fb, _ in fsizes],
                         np.int64)
        base_f = cap_f // (2 * nch) - 8
        if reservoir:
            f_energy = e_gc[s, :, : G_s[s]].sum(0).reshape(
                n_frames, 2).sum(1) + 1e-12
            loud_f = (f_energy > 2.0 * float(np.median(f_energy))) | \
                (bts_s[s].reshape(n_frames, 2) == 2).any(1)
            base_f = np.minimum(base_f, 3900)
        else:
            loud_f = np.zeros(n_frames, bool)
        horizon = 16
        upcoming = np.zeros(n_frames, bool)
        if loud_f.any():
            nxt = np.minimum.accumulate(
                np.where(loud_f, np.arange(n_frames), 1 << 30)[::-1])[::-1]
            upcoming = (nxt - np.arange(n_frames)) <= horizon
        feed_f = np.where(loud_f | ~upcoming, 0, 64)
        if reservoir:
            granted = np.empty(n_frames, np.int64)
            res_lb = 0
            cap_res = ReservoirMux.MAX_BACK * 8
            for f in range(n_frames):
                avail = min(max(res_lb, 0), 3000)
                if loud_f[f]:
                    bud = base_f[f] + avail // (2 * nch)
                else:
                    bud = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
                granted[f] = int(min(bud, 3900))
                res_lb = min(res_lb + cap_f[f] - 2 * nch * granted[f] - 7,
                             cap_res)
        else:
            granted = base_f.copy()
        cap_s.append(cap_f)
        base_s.append(base_f)
        loud_s.append(loud_f)
        feed_s.append(feed_f)
        granted_s.append(granted)
    _mark('passA_walk')

    # ---- device quantization --------------------------------------------
    # device emission (encoder/emit_device.py): the deferred/reservoir
    # path downloads packed bitstream bytes instead of spectra
    device_emit = (reservoir and bool(getattr(ecfg, "device_emit", True))
                   and os.environ.get("MP3TPU_DEVICE_EMIT", "1") != "0")
    from . import native_emit
    CAP = native_emit._CAP
    bits_bytes = np.zeros((n_gc, CAP), np.uint8)
    meta = np.zeros((n_gc, 6), np.int32)
    emitted = np.zeros(n_gc, bool)
    ix_a = np.zeros((n_gc, 576), np.int16)
    gg_a = np.full(n_gc, 210, np.int64)
    lsf_a = np.zeros((n_gc, 21), np.int64)
    ssf_a = np.zeros((n_gc, 3, 12), np.int64)
    sbg_a = np.zeros((n_gc, 3), np.int64)
    hbits_a = np.zeros(n_gc, np.int64)
    tsel_a = np.zeros((n_gc, 3), np.int64)
    c1t_a = np.zeros(n_gc, np.int64)

    def quantize_rows_dev(idx, budgets, defer=False):
        """idx: gc indices (0..n_gc); budgets aligned with idx.

        defer=True dispatches the same device loops but downloads ONLY
        the pass-B planning outputs (bits + scalefactors); the spectra
        stay on device. Returns ((bits, lsf, ssf), pend_list) where
        pend_list entries are (gc_ids, kind, _Pending) for
        finalize_pending — most pass-A rows are re-quantized by pass B,
        so eager full downloads would be largely wasted bytes.

        defer="pending" dispatches and returns pend_list alone with NO
        downloads at all (not even the light outputs): the caller can
        run other transfers while the device computes, then
        finalize_pending everything."""
        b = budgets.astype(np.int64)
        btr = bt_all[idx]
        shaped_l = (btr != 2) & noise_shaping
        shaped_s = (btr == 2) & noise_shaping
        plain = ~shaped_l & ~shaped_s
        light = defer is True
        pend_only = defer == "pending"
        if light or pend_only:
            pend_list = []
        o_lsf = np.zeros((len(idx), 21), np.int64)
        o_ssf = np.zeros((len(idx), 3, 12), np.int64)
        o_bits = np.zeros(len(idx), np.int64)
        if not (light or pend_only):
            o_ix = np.zeros((len(idx), 576), np.int16)
            o_gg = np.full(len(idx), 210, np.int64)
            o_sbg = np.zeros((len(idx), 3), np.int64)
            o_ts = np.zeros((len(idx), 3), np.int64)
            o_c1 = np.zeros(len(idx), np.int64)
        if shaped_l.any():
            # long-LAYOUT rows: 0 plus start/stop 1/3 (long spectrum +
            # long sfb shaping; block_type switches the region split)
            for bt in (0, 1, 3):
                sel = np.nonzero(shaped_l & (btr == bt))[0]
                if not len(sel):
                    continue
                if light or pend_only:
                    if pend_only:
                        pend = vloop_device.outer_rows_gathered_pending(
                            rows_dev, xminl_dev, vid[idx[sel]], b[sel],
                            sample_rate, block_type=int(bt))
                    else:
                        (sf, bits), pend = \
                            vloop_device.outer_rows_gathered_light(
                                rows_dev, xminl_dev, vid[idx[sel]], b[sel],
                                sample_rate, block_type=int(bt))
                        o_lsf[sel], o_bits[sel] = sf, bits
                    pend_list.append((idx[sel], "long",
                                      "long" if bt == 0 else "switched",
                                      b[sel], pend))
                    continue
                gg, sf, _has, ix, bits, ts, c1 = \
                    vloop_device.outer_rows_gathered(
                        rows_dev, xminl_dev, vid[idx[sel]], b[sel],
                        sample_rate, block_type=int(bt))
                o_ix[sel], o_gg[sel], o_lsf[sel] = ix, gg, sf
                o_bits[sel], o_ts[sel], o_c1[sel] = bits, ts, c1
        if shaped_s.any():
            sel = np.nonzero(shaped_s)[0]
            if light or pend_only:
                if pend_only:
                    pend = vloop_device.outer_rows_short_gathered_pending(
                        rows_dev, xmins_dev, vid[idx[sel]], b[sel],
                        sample_rate)
                else:
                    (sf, bits), pend = \
                        vloop_device.outer_rows_short_gathered_light(
                            rows_dev, xmins_dev, vid[idx[sel]], b[sel],
                            sample_rate)
                    o_ssf[sel], o_bits[sel] = sf, bits
                pend_list.append((idx[sel], "short", "short", b[sel],
                                  pend))
            else:
                gg, sf, sbg, _has, ix, bits, ts, c1 = \
                    vloop_device.outer_rows_short_gathered(
                        rows_dev, xmins_dev, vid[idx[sel]], b[sel],
                        sample_rate)
                o_ix[sel], o_gg[sel] = ix, gg
                o_ssf[sel], o_sbg[sel] = sf, sbg
                o_bits[sel], o_ts[sel], o_c1[sel] = bits, ts, c1
        if plain.any():
            for bt in np.unique(btr[plain]):
                sel = np.nonzero(plain & (btr == bt))[0]
                if light or pend_only:
                    if pend_only:
                        pend = vloop_device.rate_rows_gathered_pending(
                            rows_dev, vid[idx[sel]], b[sel], sample_rate,
                            int(bt))
                    else:
                        (bits,), pend = \
                            vloop_device.rate_rows_gathered_light(
                                rows_dev, vid[idx[sel]], b[sel],
                                sample_rate, int(bt))
                        o_bits[sel] = bits
                    lay = ("long" if bt == 0
                           else "short" if bt == 2 else "switched")
                    pend_list.append((idx[sel], "rate", lay, b[sel], pend))
                    continue
                gg, _has, ix, bits, ts, c1 = \
                    vloop_device.rate_rows_gathered(
                        rows_dev, vid[idx[sel]], b[sel], sample_rate,
                        int(bt))
                o_ix[sel], o_gg[sel] = ix, gg
                o_bits[sel], o_ts[sel], o_c1[sel] = bits, ts, c1
        if pend_only:
            return pend_list
        if light:
            return (o_bits, o_lsf, o_ssf), pend_list
        return o_ix, o_gg, o_lsf, o_ssf, o_sbg, o_bits, o_ts, o_c1

    def finalize_pending(pend_list, keep_mask, verify_p23=False):
        """Download deferred results for the rows keep_mask selects
        (identical values to the eager path: same device Arrays,
        post-processed by the same post_* helpers). Entries carry the
        GLOBAL gc ids of their rows; fetch_rows takes local positions.

        With device_emit on, the packed part2+part3 BYTES download
        instead of the spectra (emit_device via _Pending.emit_and_take
        — ~83% of the path's D2H removed); bits_bytes/meta/p23 are
        written directly and the host emitter is bypassed for these
        rows. verify_p23 pins the count==emit contract against the
        host-side pass-A predictions."""
        for gids, kind, layout, bud, pend in pend_list:
            loc = np.nonzero(keep_mask[gids])[0]
            if not len(loc):
                continue
            tgt = gids[loc]
            if device_emit:
                vloop_device.take_iter_stats(pend, kind, layout)  # telemetry
                cap_bits = np.minimum(bud + 94, 3994)
                by, m5, gg, tcols, c1, hb, sbg = pend.emit_and_take(
                    kind, layout, sample_rate, kind != "rate", cap_bits)
                wb = by.shape[1]
                bits_bytes[tgt, :wb] = by[loc]
                meta[tgt, :5] = m5[loc]
                gg_a[tgt] = gg[loc]
                tsel_a[tgt] = vloop_device._TID[tcols[loc].astype(np.int64)]
                c1t_a[tgt] = c1[loc]
                hbits_a[tgt] = hb[loc]
                if sbg is not None:
                    sbg_a[tgt] = sbg[loc]
                # count == emit, device-to-device: the emitter's bit
                # total must equal the count kernel's huffman bits plus
                # the scalefactor side bits its sfc implies
                sfc = m5[loc, 2].astype(np.int64)
                if layout == "short":
                    sfb = 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
                else:
                    sfb = 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
                if not np.array_equal(m5[loc, 0].astype(np.int64),
                                      hb[loc].astype(np.int64) + sfb):
                    raise RuntimeError("device emitter/count drift")
                if verify_p23 and not np.array_equal(  # vs pass-A plan
                        m5[loc, 0].astype(np.int64), p23[tgt]):
                    raise RuntimeError("emitter/p23 drift")
                p23[tgt] = m5[loc, 0]
                emitted[tgt] = True
                continue
            raw = pend.fetch_rows(loc)
            if kind == "long":
                gg, sf, _has, ix, bits, ts, c1 = vloop_device.post_long(
                    raw, label=layout)
                ix_a[tgt], gg_a[tgt], lsf_a[tgt] = ix, gg, sf
            elif kind == "short":
                gg, sf, sbg, _has, ix, bits, ts, c1 = \
                    vloop_device.post_short(raw)
                ix_a[tgt], gg_a[tgt] = ix, gg
                ssf_a[tgt], sbg_a[tgt] = sf, sbg
            else:
                gg, _has, ix, bits, ts, c1 = vloop_device.post_rate(raw)
                ix_a[tgt], gg_a[tgt] = ix, gg
            hbits_a[tgt], tsel_a[tgt], c1t_a[tgt] = bits, ts, c1

    def p23_of(idx):
        """part2_3_length = exact huffman bits + scalefactor side bits."""
        p = hbits_a[idx].copy()
        btr = bt_all[idx]
        if noise_shaping:
            lm = btr != 2
            if lm.any():
                sfc = vloop.pick_sfc_rows(lsf_a[idx[lm]])
                p[lm] += 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
            sm = btr == 2
            if sm.any():
                sfc = vloop.pick_sfc_short_rows(ssf_a[idx[sm]])
                p[sm] += 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
        return p

    idx_all = np.arange(n_gc)
    budgets_a = np.concatenate([np.repeat(granted_s[s], 2 * nch)
                                for s in range(B)])
    if reservoir:
        # pass A downloads only what the upgrade walk consumes (bits +
        # scalefactors, ~90 B/row); spectra stay on device until we
        # know which rows pass B re-quantizes (typically ~99%)
        (hbits_a[:], lsf_a[:], ssf_a[:]), pend_a = \
            quantize_rows_dev(idx_all, budgets_a, defer=True)
    else:
        (ix_a[:], gg_a[:], lsf_a[:], ssf_a[:], sbg_a[:], hbits_a[:],
         tsel_a[:], c1t_a[:]) = quantize_rows_dev(idx_all, budgets_a)
    p23 = p23_of(idx_all)
    _mark('quantize_all')

    # ---- pass-B upgrade walk per stream, one batched re-quantize --------
    if reservoir:
        # Upgrade only frames whose budget bump is MATERIAL (> margin
        # bits per granule-channel). Pass A's reservoir walk is a lower
        # bound that loses ~3-7 bits/frame to worst-case byte-alignment
        # pessimism, so with margin=0 nearly every frame "upgrades" by a
        # few bits and gets re-quantized on device for no audible gain
        # (99.5% of rows counted on the chirp-mix fixture). Kept frames stay coded at their pass-A budget — always
        # conformant (coding under budget is legal) — and their EXACT
        # coded size feeds the walk, which is what actually grows the
        # reservoir for the loud frames that need real upgrades.
        # Counted on the chirp-mix bench fixture: want-granted deltas
        # cluster in the tens of bits (p50=25-62 / max=37-73 across
        # fixtures) — pure alignment slack (a steady-loudness stream
        # saturates the 3000-bit avail cap in both walks, so
        # want==granted modulo the -7/frame lower-bound pessimism, and
        # the slack scales with how much of each frame the alignment
        # rounding touches). Genuine reclaims (quiet stretch ->
        # transient) are hundreds of bits and sail over the margin; at
        # 128k stereo a skipped ~96-bit bump is ~2% of a frame budget
        # (<0.1 dB).
        margin = int(os.environ.get("MP3TPU_UPGRADE_MARGIN", "96"))
        _deltas = [] if _prof else None
        upg_idx_parts, upg_bud_parts = [], []
        for s in range(B):
            n_frames = G_s[s] // 2
            granted = granted_s[s]
            cap_f = cap_s[s]
            fsum = p23[offs[s]: offs[s + 1]].reshape(n_frames, 2 * nch).sum(1)
            final = granted.copy()
            stream_bits = 0
            placed_bytes = 0
            loud_f, base_f, feed_f = loud_s[s], base_s[s], feed_s[s]
            for f in range(n_frames):
                res = placed_bytes * 8 - stream_bits
                avail = min(max(res, 0), 3000)
                if loud_f[f]:
                    want = base_f[f] + avail // (2 * nch)
                else:
                    want = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
                want = int(min(want, 3900))
                if _deltas is not None and want > granted[f]:
                    _deltas.append(want - granted[f])
                if want > granted[f] + margin:
                    final[f] = want
                    used = 2 * nch * want
                else:
                    used = int(fsum[f])
                stream_bits = (stream_bits + used + 7) & ~7
                placed_bytes += int(cap_f[f]) // 8
                excess = (placed_bytes - stream_bits // 8
                          - ReservoirMux.MAX_BACK)
                if excess > 0:
                    stream_bits += excess * 8
            upg_f = np.nonzero(final > granted)[0]
            if len(upg_f):
                gidx = (offs[s] + upg_f[:, None] * 2 * nch
                        + np.arange(2 * nch)).ravel()
                upg_idx_parts.append(gidx)
                upg_bud_parts.append(np.repeat(final[upg_f], 2 * nch))
                granted_s[s] = final
        keep_mask = np.ones(n_gc, bool)
        if _deltas is not None and _deltas:
            d = np.sort(np.asarray(_deltas))
            _ph['upg_want_gt_granted'] = len(d)
            _ph['upg_delta_p50'] = int(d[len(d) // 2])
            _ph['upg_delta_p90'] = int(d[(len(d) * 9) // 10])
            _ph['upg_delta_max'] = int(d[-1])
        if upg_idx_parts:
            uidx = np.concatenate(upg_idx_parts)
            keep_mask[uidx] = False
            if _prof:
                _ph['upgraded_rows'] = len(uidx)
                _ph['total_rows'] = n_gc
        # Enqueue ALL pass-B dispatches first (their H2D index uploads
        # must not queue behind bulk downloads), only then start the
        # pass-A downloads — those bytes stream while the device
        # computes the upgrades.
        if upg_idx_parts:
            ubud = np.concatenate(upg_bud_parts)
            pend_b = quantize_rows_dev(uidx, ubud, defer="pending")
            if not device_emit:
                # emitted mode never downloads the wire spectra, so
                # there is nothing worth prefetching ahead of pass B
                for _g, _k, _l, _b, pend in pend_a:
                    pend.prefetch()
            finalize_pending(pend_a, keep_mask, verify_p23=device_emit)
            finalize_pending(pend_b, ~keep_mask)
            if not device_emit:
                p23[uidx] = p23_of(uidx)
        else:
            finalize_pending(pend_a, keep_mask, verify_p23=device_emit)
        pend_a = None
    _mark('passB_upgrade')

    # ---- emission: host path for rows the device didn't emit ------------
    # (all of them with device_emit off / the eager no-reservoir path;
    # none with it on — the deferred finalize wrote bits_bytes directly)
    todo = np.nonzero(~emitted)[0]
    use_sf = np.full(n_gc, bool(noise_shaping))
    from ..bitstream import native as _nat
    import ctypes
    lib = _nat._load()
    have_native = (len(todo) > 0 and lib is not None
                   and hasattr(lib, "mp3tpu_encode_rows"))
    if have_native:
        nt = len(todo)
        pp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        ix16 = np.ascontiguousarray(ix_a[todo], np.int16)
        bt8 = np.ascontiguousarray(bt_all[todo], np.uint8)
        us8 = np.ascontiguousarray(use_sf[todo], np.uint8)
        lsf16 = np.ascontiguousarray(lsf_a[todo], np.int16)
        ssf16 = np.ascontiguousarray(ssf_a[todo].reshape(nt, 36), np.int16)
        ts16 = np.ascontiguousarray(tsel_a[todo], np.int16)
        c18 = np.ascontiguousarray(c1t_a[todo], np.uint8)
        bb = np.zeros((nt, CAP), np.uint8)
        mt = np.zeros((nt, 6), np.int32)
        fn = lib.mp3tpu_encode_rows
        fn.restype = ctypes.c_int
        rr = fn(pp(ix16), pp(bt8), pp(us8), pp(lsf16), pp(ssf16), pp(ts16),
                pp(c18), ctypes.c_int32(native_emit._SR9[sample_rate]),
                ctypes.c_int32(nt), pp(bb), ctypes.c_int32(CAP),
                pp(mt))
        have_native = rr == 0
        if have_native:
            bits_bytes[todo] = bb
            meta[todo] = mt
    if not have_native:
        for i in todo:
            b = int(bt_all[i])
            kw = {}
            if use_sf[i] and b != 2:
                kw = dict(long_sf=lsf_a[i])
            if use_sf[i] and b == 2:
                kw = dict(short_sf=ssf_a[i],
                          subblock_gain=tuple(int(x) for x in sbg_a[i]))
            g = encode_granule(np.asarray(ix_a[i], np.int32), int(gg_a[i]),
                               sample_rate, b, tsel=tsel_a[i],
                               c1table=int(c1t_a[i]), **kw)
            row = np.packbits(np.asarray(g.bits.bits, np.uint8))
            bits_bytes[i, : len(row)] = row
            meta[i] = (g.part2_3_length, g.big_values, g.scalefac_compress,
                       g.region0_count, g.region1_count, 0)
    # emission must agree with the predicted exact counts — this is the
    # count == emit contract the reservoir replay depends on
    if not np.array_equal(meta[:, 0].astype(np.int64), p23):
        raise RuntimeError("emitter/count drift")
    _mark('emit')

    def rows_host(gi):
        """Download the few rows a refit needs (rare overdrafts)."""
        return np.asarray(
            jnp.take(rows_dev, jnp.asarray(vid[gi]), axis=0), np.float64)

    # ---- per-stream overdraft guard + packed mux ------------------------
    from .mux_packed import assemble_stream
    out = []
    for s in range(B):
        n_frames = G_s[s] // 2
        cap_f = cap_s[s]
        sl = slice(int(offs[s]), int(offs[s + 1]))
        stream_bits = 0
        placed_bytes = 0
        for f in range(n_frames):
            g0 = int(offs[s]) + f * 2 * nch
            need = int(p23[g0: g0 + 2 * nch].sum())
            res_now = placed_bytes * 8 - stream_bits
            if need > int(cap_f[f]) + res_now:
                avail = min(max(res_now, 0), 3000)
                bud = int(min(base_s[s][f] + avail // (2 * nch), 3900))
                gi = np.arange(g0, g0 + 2 * nch)
                rh = rows_host(gi)
                for bt in np.unique(bt_all[gi]):
                    m = np.nonzero(bt_all[gi] == bt)[0]
                    ixr, ggr = vloop.inner_rate_rows(
                        rh[m], np.full(len(m), bud, np.int64),
                        sample_rate, int(bt))
                    for j, mi in enumerate(m):
                        i = int(gi[mi])
                        g = encode_granule(ixr[j], int(ggr[j]),
                                           sample_rate, int(bt))
                        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
                        bits_bytes[i] = 0
                        bits_bytes[i, : len(row)] = row
                        meta[i] = (g.part2_3_length, g.big_values,
                                   g.scalefac_compress, g.region0_count,
                                   g.region1_count, 0)
                        tsel_a[i] = g.table_select
                        c1t_a[i] = g.count1table_select
                        gg_a[i] = g.global_gain
                        sbg_a[i] = 0
                        p23[i] = g.part2_3_length
                need = int(p23[g0: g0 + 2 * nch].sum())
            stream_bits += need
            stream_bits = (stream_bits + 7) & ~7
            placed_bytes += int(cap_f[f]) // 8
            excess = placed_bytes - stream_bits // 8 - ReservoirMux.MAX_BACK
            if excess > 0:
                stream_bits += excess * 8
        body = assemble_stream(
            bits_bytes[sl], p23[sl], meta[sl, 1].astype(np.int64),
            gg_a[sl], meta[sl, 2].astype(np.int64), bt_all[sl], tsel_a[sl],
            sbg_a[sl], meta[sl, 3].astype(np.int64),
            meta[sl, 4].astype(np.int64), c1t_a[sl], ms_s[s],
            nch, sr_idx, br_idx, sample_rate, bitrate)
        if gapless_tag:
            xing_bytes = FrameSizer(sample_rate, bitrate * 1000).next()[0]
            xing = build_xing_frame(nch, sr_idx, br_idx, xing_bytes,
                                    n_frames=n_frames,
                                    n_bytes=len(body) + xing_bytes,
                                    encoder_delay=ENCODER_DELAY,
                                    encoder_padding=encpad_s[s])
            body = xing + body
        out.append(body)
    _mark('mux')
    if _prof:
        global LAST_PROFILE
        LAST_PROFILE = dict(_ph)
        print('MP3TPU_ENCODE_PROFILE', {k: round(v, 3) for k, v in _ph.items()}, flush=True)
    return out
