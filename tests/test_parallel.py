"""Multi-device sharding tests on the 8-virtual-device CPU mesh
(SURVEY.md §2.4 P2/P6, §4.4 "multi-node without a cluster")."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

# these tests need the 8-virtual-device CPU mesh the conftest provisions
# on the CPU backend; a single GPU has one device — skip there
# (`chip_smoke.py --multi` covers sharding on four cards)
if len(jax.devices()) < 8:
    pytestmark = pytest.mark.skip(reason="needs 8 devices (CPU mesh)")

from mp3tpu.kernels import pipeline as kp
from mp3tpu.parallel.mesh import make_stream_mesh, shard_batch, stream_sharding

import fixtures


def _batch_from_fixture(S):
    from mp3tpu.bitstream.unpack import unpack
    mp3 = fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo")
    st = unpack(mp3)
    G = 32
    tile = lambda a: jnp.asarray(np.tile(a[:G][None], (S,) + (1,) * a.ndim))
    return (tile(st.is_), tile(st.exp), tile(st.block_type),
            tile(st.mixed), tile(st.smode)), st.sample_rate


def test_mesh_creation():
    mesh = make_stream_mesh(8)
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("streams",)


def test_sharded_decode_matches_single_device():
    pytest.importorskip("lameref")
    S = 8
    batch, sr = _batch_from_fixture(S)
    state = kp.init_state(S)
    ref, _ = kp.decode_window_i16(*batch, state, sr)

    mesh = make_stream_mesh(8)
    sbatch = shard_batch(mesh, batch)
    sstate = jax.tree.map(
        lambda a: jax.device_put(a, stream_sharding(mesh)), kp.init_state(S))
    got, new_state = kp.decode_window_i16(*sbatch, sstate, sr)
    assert len(got.sharding.device_set) == 8  # stayed sharded
    # identical per-stream math; same executable shape -> tolerance 0
    # is expected, but allow 1 LSB in case sharding changes fusion
    d = np.abs(np.asarray(ref).astype(np.int32) - np.asarray(got).astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() > 0.999


def test_sharded_packed_scan_matches_single_device():
    """The PRODUCTION fast path (packed 4-bit planes + scan + fused
    resample — what bench.py and decode_files actually run) under the
    8-device mesh produces the same rows as single-device (VERDICT
    round-2 item 6)."""
    pytest.importorskip("lameref")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mp3tpu.bitstream import native as nat
    from mp3tpu.bitstream.native import unpack_native_into12
    if not nat.available():
        pytest.skip("native unpacker unavailable")
    import ctypes
    mp3 = fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo")
    lib = nat._load()
    meta4 = (ctypes.c_int32 * 4)()
    G = lib.mp3tpu_probe(mp3, len(mp3), meta4)
    S, win = 8, 8
    n_win = -(-G // win)   # pad window: zero planes in both paths
    # production widening chain (the fast path's): 4-bit plane first,
    # widen if a granule-channel overflows its sideband
    for plane_bits in (4, 8, 12):
        shp = {4: 288, 8: 576, 12: 864}[plane_bits]
        dt = {4: np.uint8, 8: np.int8, 12: np.uint8}[plane_bits]
        esc_shape = {4: (80,), 8: (16, 2), 12: (16, 2)}[plane_bits]
        esc_dt = np.int8 if plane_bits == 4 else np.int16
        b = {
            "is12": np.zeros((n_win, S, win, 2, shp), dt),
            "esc": np.zeros((n_win, S, win, 2) + esc_shape, esc_dt),
            "exp": np.zeros((n_win, S, win, 2, 65), np.uint8),
            "bt": np.zeros((n_win, S, win, 2), np.int8),
            "mx": np.zeros((n_win, S, win, 2), np.uint8),
            "smode": np.zeros((n_win, S, win, 64), np.uint8),
        }
        ok = all(unpack_native_into12(
            mp3, G, None, b["exp"], b["bt"], b["mx"], b["smode"],
            b["is12"], b["esc"], k, S, win, plane_bits=plane_bits | 0x10)
            for k in range(S))
        if ok:
            break
    assert ok
    sr = 44100
    args = tuple(jnp.asarray(b[k])
                 for k in ("is12", "exp", "esc", "bt", "mx", "smode"))
    ref, _, _ = kp.decode_all_windows_flat_resampled_i16(
        *args, kp.init_state(S), kp.init_resample_state(S, sr), sr,
        48000, plane_bits=plane_bits)
    ref = np.asarray(ref)

    mesh = make_stream_mesh(8)
    win_sh = NamedSharding(mesh, P(None, "streams"))
    row_sh = NamedSharding(mesh, P("streams"))
    sargs = tuple(jax.device_put(a, win_sh) for a in args)
    sstate = jax.tree.map(lambda a: jax.device_put(a, row_sh),
                          kp.init_state(S))
    srs = jax.device_put(kp.init_resample_state(S, sr), row_sh)
    got, _, _ = kp.decode_all_windows_flat_resampled_i16(
        *sargs, sstate, srs, sr, 48000, plane_bits=plane_bits)
    assert len(got.sharding.device_set) == 8
    d = np.abs(ref.astype(np.int32) - np.asarray(got).astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() > 0.999


def test_sharded_encode_batch_matches_single():
    """P2 for the ENCODER (VERDICT r4 task 4): encode_batch with a
    stream-sharded mesh produces byte-identical MP3 output to the
    single-device path — streams are independent, so SPMD partitioning
    must not change any per-row math."""
    from mp3tpu.encoder import encode_batch
    sr = 44100
    rng = np.random.default_rng(3)
    t = np.arange(int(0.3 * sr)) / sr
    pcms = [(0.3 * np.sin(2 * np.pi * (260 + 45 * i) * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
            for i in range(8)]
    ref = encode_batch(pcms, sr, bitrate=128)
    mesh = make_stream_mesh(8)
    got = encode_batch(pcms, sr, bitrate=128, mesh=mesh)
    assert [len(b) for b in got] == [len(b) for b in ref]
    assert all(a == b for a, b in zip(ref, got))


def test_graft_dryrun_multichip():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_graft_dryrun_self_provisions():
    """Driver scenario: the process is bound to a 1-device platform and
    dryrun_multichip(8) must provision the virtual CPU mesh itself
    (VERDICT round-1 item 1)."""
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (re.sub(
        r"--xla_force_host_platform_device_count=\d+", "",
        env.get("XLA_FLAGS", "")) +
        " --xla_force_host_platform_device_count=1").strip()
    env.pop("MP3TPU_DRYRUN_NO_REEXEC", None)
    code = (
        f"import sys; sys.path.insert(0, {repo!r})\n"
        "import jax\n"
        "assert len(jax.devices()) == 1, jax.devices()\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(4)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip OK: 4 devices" in out.stdout, out.stdout


def test_graft_entry_compiles():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].dtype == jnp.int16
