"""mp3tpu benchmark — aggregate decode realtime factor on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Config: BASELINE.json config 3 — batched multi-stream decode of
44.1 kHz joint-stereo CBR 128k MP3 (256 streams) PLUS polyphase
resampling to 48 kHz, end-to-end: host bitstream unpack (C++ fast
path) + the device granule pipeline + fused device resampler. Value is
seconds of audio decoded per wall second on one GPU.

`python bench.py` runs the measurement in 3 fresh processes, one after
another (one JAX process per card), and prints the MEDIAN run's JSON
with every run's value disclosed (`runs_x`). `python bench.py --single`
runs one measurement directly (`--no-api` skips the 64-stream API
figures). Needs a GPU: exits non-zero without one.

Structure: host unpack, staging of the stream-group arenas, one jitted
regroup pass that concatenates the groups on device, then ONE lax.scan
dispatch decodes all windows and resamples the whole stream
(kernels.decode_all_windows_flat_resampled_i16) — the windowed
resample phase never resets (streaming-exact).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))

import numpy as np


def _fixture_mp3(seconds: float = 10.0, sr: int = 44100) -> bytes:
    """A realistic music-like CBR 128k joint-stereo fixture. Prefers the
    system LAME (real-world encoder); falls back to crafted frames."""
    try:
        import lameref
        n = int(seconds * sr)
        t = np.arange(n) / sr
        f0, f1 = 40.0, 15000.0
        k = np.log(f1 / f0)
        ph = 2 * np.pi * f0 * (np.exp(t / t[-1] * k) - 1) * t[-1] / k
        rng = np.random.default_rng(7)
        sig = 0.35 * np.sin(ph) + 0.15 * np.sin(2.1 * ph) + 0.02 * rng.standard_normal(n)
        pcm = np.stack([sig, 0.8 * sig + 0.05 * np.sin(3.3 * ph)], 1)
        return lameref.encode(np.clip(pcm, -0.99, 0.99), sr,
                              bitrate=128, mode="jstereo", write_vbr_tag=False)
    except Exception:
        from craft import GranuleSpec, craft_frame
        gr = GranuleSpec(part2_3_length=24, big_values=8,
                         table_select=(1, 1, 1), region0_count=15, region1_count=7,
                         main_bits="011001011001011001011001")
        return craft_frame(gr, GranuleSpec()) * int(seconds * 38.28)


def require_gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"{os.path.basename(sys.argv[0])}: needs a GPU, JAX "
                 f"found {jax.devices()[0].platform}")


def main(with_api: bool = True):
    import jax
    import jax.numpy as jnp
    from mp3tpu.bitstream.unpack import unpack_fast
    from mp3tpu.bitstream.native import unpack_native_into12
    from mp3tpu.kernels import pipeline as kp

    n_streams = 256
    win = 32          # granules per device window (HBM + program sweet spot)
    n_groups = 128    # stream groups staged independently (<=2 MB each)
    Sg = n_streams // n_groups
    mp3 = _fixture_mp3(10.0)
    st0 = unpack_fast(mp3)  # warm table/LUT init
    sr = st0.sample_rate
    G = (st0.n_granules // win) * win
    n_win = G // win
    audio_seconds_total = n_streams * G * 576 / sr

    # group-major batch tensors [n_win, Sg, win, ...] per group: the C++
    # unpacker writes each stream's granules directly into place (B5
    # zero-copy batch assembly); a group is stageable the moment its last
    # stream is unpacked, while later groups are still unpacking.
    # Spectrum ships as the 4-bit nibble plane (values outside [-7,7] in
    # a POSITION-FREE 64-slot escape sideband, landed on device by
    # marker rank — measured ~8/gc mean, <=54 max on music-like 128 kbps
    # content); falls back to the 8-bit then 12-bit plane if any
    # granule-channel overflows its sideband.
    # Exponents ship as the compact uint8[65] plane ([gg, offset+128]
    # per gc, half the bytes of int16[64]); falls back to int16 if any
    # offset leaves [-128, 0] (impossible for MPEG-1 input).
    plane_bits = 4
    exp_bytes = True
    plane_shape = {4: (288,), 8: (576,), 12: (864,)}
    plane_dtype = {4: np.uint8, 8: np.int8, 12: np.uint8}
    esc_shape = {4: (80,), 8: (16, 2), 12: (16, 2)}
    esc_dtype = {4: np.int8, 8: np.int16, 12: np.int16}

    def exp_arr():
        if exp_bytes:
            return np.zeros((n_win, Sg, win, 2, 65), np.uint8)
        return np.zeros((n_win, Sg, win, 2, 64), np.int16)

    def make_group():
        """One stream-group's staging buffers. In the all-byte plane
        family (4-bit spectrum + int8 sideband + byte exponents) the six
        arrays are VIEWS into one contiguous uint8 ARENA — the group
        stages as ONE device_put (128 transfers instead of 768)."""
        if plane_bits == 4 and exp_bytes:
            total, layout = kp.arena_layout(n_win, Sg, win)
            arena = np.zeros(total, np.uint8)
            g = {"_arena": arena}
            for k2, off, shp, dt in layout:
                n2 = int(np.prod(shp))
                g[k2] = arena[off:off + n2].view(dt).reshape(shp)
            return g
        return {
            "is12": np.zeros((n_win, Sg, win, 2) + plane_shape[plane_bits],
                             plane_dtype[plane_bits]),
            "esc": np.zeros((n_win, Sg, win, 2) + esc_shape[plane_bits],
                            esc_dtype[plane_bits]),
            "exp": exp_arr(),
            "bt": np.zeros((n_win, Sg, win, 2), np.int8),
            "mx": np.zeros((n_win, Sg, win, 2), np.uint8),
            "smode": np.zeros((n_win, Sg, win, 64), np.uint8),
        }
    groups = [make_group() for _ in range(n_groups)]
    for g in groups:
        for k2, a in g.items():
            if k2 == "_arena" or "_arena" not in g:
                a.fill(1)  # pre-fault pages outside the timed region
                a.fill(0)

    def _unpack_one(si):
        g = groups[si // Sg]
        return unpack_native_into12(
            mp3, G, None, g["exp"], g["bt"], g["mx"], g["smode"],
            g["is12"], g["esc"], si % Sg, Sg, win,
            plane_bits=plane_bits | (0x10 if exp_bytes else 0))
    while not _unpack_one(0):  # sideband/offset overflow: widen planes
        if exp_bytes:
            exp_bytes = False      # first retry: int16 exponents
        else:
            plane_bits = {4: 8, 8: 12}[plane_bits]
        groups = [make_group() for _ in range(n_groups)]
        for g in groups:
            for k2, a in g.items():
                if k2 == "_arena" or "_arena" not in g:
                    a.fill(1)
                    a.fill(0)
        if plane_bits == 12 and not exp_bytes:
            assert _unpack_one(0)
            break

    # ---- timed phase 1: host unpack (C++ fast path, one thread) -------
    t0 = time.perf_counter()
    for si in range(n_streams):
        assert _unpack_one(si)
    t_unpack = time.perf_counter() - t0

    # ---- timed phase 2: staging — one async device_put per group
    # arena (<=2 MB each), drained once at the end ---------------------
    ts0 = time.perf_counter()
    dev_groups = []
    staged_bytes = 0
    arena_mode = "_arena" in groups[0]
    for g in groups:
        if arena_mode:
            staged_bytes += g["_arena"].nbytes
            dev_groups.append(jax.device_put(g["_arena"]))
        else:
            staged_bytes += sum(a.nbytes for a in g.values())
            dev_groups.append(jax.device_put(g))
    enqueue_t = time.perf_counter() - ts0
    jax.block_until_ready(dev_groups)
    t_stage = time.perf_counter() - ts0
    stage_drain_t = t_stage - enqueue_t
    t_pipe = t_unpack + t_stage

    # one-time jit compile (untimed warmup: once per deployment, served
    # from the persistent compilation cache in production; SURVEY.md §3.5)
    if arena_mode:
        def regroup():
            i12, es, ex, btd, mxd, smd = kp.regroup_device_arenas(
                dev_groups, n_win, Sg, win)
            return (i12, ex, es, btd, mxd, smd)
    else:
        dev = {k: [dg[k] for dg in dev_groups]
               for k in ("is12", "exp", "esc", "bt", "mx", "smode")}

        def regroup():
            return kp.regroup_device(dev["is12"], dev["exp"], dev["esc"],
                                     dev["bt"], dev["mx"], dev["smode"])

    def call(d, st_, rst_):
        # ONE dispatch: lax.scan over all windows + one whole-stream
        # resample (streaming-exact: resample phase never resets)
        return kp.decode_all_windows_flat_resampled_i16(
            *d, st_, rst_, sr, 48000, plane_bits=plane_bits)
    dwarm = regroup()
    pcm16, _, _ = call(dwarm, kp.init_state(n_streams),
                       kp.init_resample_state(n_streams, sr))
    pcm16.block_until_ready()
    del dwarm

    # ---- timed phase 3: device — one regroup pass (group tensors ->
    # whole-batch window-major tensors in HBM), then one all-windows
    # decode+resample dispatch
    t2 = time.perf_counter()
    dcat = regroup()
    pcm16, state, rs_state = call(dcat, kp.init_state(n_streams),
                                  kp.init_resample_state(n_streams, sr))
    pcm16.block_until_ready()
    t_dev = time.perf_counter() - t2
    wall = t_pipe + t_dev

    # device-compute-only reference (inputs already device-resident):
    # isolates the device pipeline from host unpack and staging
    state0 = kp.init_state(n_streams)
    rst0 = kp.init_resample_state(n_streams, sr)
    tc = time.perf_counter()
    for _ in range(2):
        p0, _, _ = call(dcat, state0, rst0)
    p0.block_until_ready()
    t_compute = (time.perf_counter() - tc) / 2
    compute_x = (n_streams * G * 576 / sr) / t_compute

    assert int(np.abs(np.asarray(pcm16[0, :1000])).max()) > 0, "silent output"

    # ---- API-level figures on a 64-stream batch ----------------------
    api_x = api_dev_x = t_api = t_dev_api = None
    if with_api:
        _api_figures = _measure_api(mp3)
        api_x, t_api, api_dev_x, t_dev_api = _api_figures
    upload_gbps = staged_bytes / max(t_stage, 1e-9) / 1e9
    value = audio_seconds_total / wall
    result = {
        "metric": "aggregate_decode_realtime_factor",
        "value": round(value, 1),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(value / 1000.0, 3),
        "detail": {
            "streams": n_streams,
            "audio_seconds": round(audio_seconds_total, 1),
            "pipeline_s": round(t_pipe, 3),         # unpack + staging
            "host_unpack_s": round(t_unpack, 3),
            "stage_s": round(t_stage, 3),
            "stage_enqueue_s": round(enqueue_t, 3),  # inside stage_s
            "device_s": round(t_dev, 3),
            "host_x": round(audio_seconds_total / max(t_unpack, 1e-9), 1),
            "device_x": round(audio_seconds_total / max(t_dev, 1e-9), 1),
            "device_compute_only_x": round(compute_x, 1),
            "upload_gbps": round(upload_gbps, 3),
            "plane_bits": plane_bits,
            "exp_bytes": exp_bytes,
        },
    }
    if with_api:
        result["detail"].update({
            "api_decode_batch_x": round(api_x, 1),
            "api_decode_batch_s": round(t_api, 3),
            "api_device_batch_x": round(api_dev_x, 1),
            "api_device_batch_s": round(t_dev_api, 3),
        })
    print(json.dumps(result))
    return result


def _measure_api(mp3: bytes):
    """Public decode_files figures on a 64-stream batch (run in the
    first child only — compile shapes are shared across children via
    the persistent cache, and the figure is not part of the median)."""
    import time

    import jax
    from mp3tpu.pipeline import decode_files
    api_batch = [mp3] * 64
    decode_files([mp3])  # warm that path's jit shapes (untimed)
    # (a) public DEVICE-resident path (VERDICT r4 task 3): PCM stays in
    # HBM — the serving-pipeline number, now reachable through the API
    decode_files([mp3], output="device")   # warm (shares shapes)
    td = time.perf_counter()
    handle = decode_files(api_batch, output="device")
    jax.block_until_ready(list({id(handle.device_pcm(i)[0]):
                                handle.device_pcm(i)[0]
                                for i in range(len(handle))}.values()))
    t_dev_api = time.perf_counter() - td
    dev_audio = sum((handle.device_pcm(i)[3] - handle.device_pcm(i)[2])
                    / handle.sample_rates[i] for i in range(len(handle)))
    api_dev_x = dev_audio / t_dev_api
    del handle
    # (b) materializing path, D2H INCLUDED (the user-facing number for
    # host PCM)
    ta = time.perf_counter()
    api_out = decode_files(api_batch)
    t_api = time.perf_counter() - ta
    api_audio = sum(len(p) / s for p, s in api_out)
    return api_audio / t_api, t_api, api_dev_x, t_dev_api


def _official():
    """Median-of-3 protocol: run the measurement in 3 FRESH processes,
    one after another (never two on the card at once), take the run
    with the MEDIAN headline value, and print ITS JSON with all three
    runs disclosed. jit compiles are served from the persistent
    compilation cache, so children beyond the first pay only the
    cache load."""
    import subprocess
    runs = []
    for i in range(3):
        cmd = [sys.executable, os.path.abspath(__file__), "--single"]
        if i > 0:
            cmd.append("--no-api")  # API figures measured once (child 1)
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=5400)
        line = next((ln for ln in reversed(r.stdout.splitlines())
                     if ln.startswith("{")), None)
        if r.returncode != 0 or line is None:
            sys.stderr.write(r.stdout[-2000:] + r.stderr[-2000:])
            raise RuntimeError(f"bench child {i + 1} failed")
        runs.append(json.loads(line))
    ordered = sorted(runs, key=lambda x: x["value"])
    med = ordered[1]
    med["detail"]["protocol"] = "median-of-3-fresh-process"
    med["detail"]["runs_x"] = [r["value"] for r in runs]
    for k in ("api_decode_batch_x", "api_decode_batch_s",
              "api_device_batch_x", "api_device_batch_s"):
        if k in runs[0]["detail"] and k not in med["detail"]:
            med["detail"][k] = runs[0]["detail"][k]
    print(json.dumps(med))
    return med


if __name__ == "__main__":
    require_gpu()
    if "--single" in sys.argv:
        main(with_api="--no-api" not in sys.argv)
    else:
        _official()
