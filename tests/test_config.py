"""Config consumption (SURVEY.md §5.6) + profiling wiring (§5.1):
the resolved Config must actually steer the runtime paths, and a trace
dir must produce an XPlane capture (VERDICT round-1 item 8)."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mp3tpu.config import Config, DecodeConfig, PlayerConfig, SchedulerConfig, \
    get_active, resolve, set_active
from mp3tpu.pipeline import decode_file

import fixtures


@pytest.fixture(autouse=True)
def _restore_active():
    old = get_active()
    yield
    set_active(old)


@pytest.fixture(scope="module")
def mp3():
    pytest.importorskip("lameref")
    return fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo",
                                 seconds=1.0)


def test_env_override_resolution(monkeypatch):
    monkeypatch.setenv("MP3TPU_ENCODE_BITRATE", "192")
    monkeypatch.setenv("MP3TPU_DECODE_GAPLESS", "false")
    monkeypatch.setenv("MP3TPU_SCHEDULER_N_SLOTS", "7")
    cfg = resolve()
    assert cfg.encode.bitrate == 192
    assert cfg.decode.gapless is False
    assert cfg.scheduler.n_slots == 7


def test_decode_config_output_and_gapless(mp3):
    """decode_file with no kwargs obeys the active config."""
    set_active(Config(decode=DecodeConfig(output="float32", gapless=False)))
    pcm, sr = decode_file(mp3)
    assert pcm.dtype == np.float32
    set_active(Config(decode=DecodeConfig(output="int16", gapless=True)))
    pcm2, _ = decode_file(mp3)
    assert pcm2.dtype == np.int16
    assert len(pcm2) < len(pcm)  # gapless trim applied


def test_use_native_flag_reaches_source(mp3):
    from mp3tpu.bitstream import native
    from mp3tpu.pipeline import load_source
    if not native.available():
        pytest.skip("native unpacker unavailable")
    set_active(Config(decode=DecodeConfig(use_native=False)))
    src, _, _ = load_source(mp3)
    assert src._native_state is None  # forced pure-Python path
    set_active(Config())
    src2, _, _ = load_source(mp3)
    assert src2._native_state is not None


def test_scheduler_uses_config_defaults(mp3):
    from mp3tpu.player import StreamScheduler
    set_active(Config(scheduler=SchedulerConfig(n_slots=3, window_granules=8)))
    sched = StreamScheduler(sample_rate=44100)
    assert sched.S == 3 and sched.win == 8
    snk = None
    from mp3tpu.player import CollectSink
    snk = CollectSink()
    sched.submit(mp3, sink=snk, apply_gapless=False)
    sched.run()
    ref, _ = decode_file(mp3, gapless=False)
    n = min(len(snk.pcm), len(ref))
    d = np.abs(snk.pcm[:n].astype(np.int32) - ref[:n].astype(np.int32))
    assert n > 20000 and d.max() <= 1


def test_player_gain_from_config(mp3):
    from mp3tpu.player import Player
    set_active(Config(player=PlayerConfig(gain_db=-20.0)))
    p = Player(mp3, apply_gapless=False)
    p.play(max_samples=20000)
    quiet = np.abs(p.sink.pcm.astype(np.int32)).max()
    set_active(Config())
    p2 = Player(mp3, apply_gapless=False)
    p2.play(max_samples=20000)
    loud = np.abs(p2.sink.pcm.astype(np.int32)).max()
    assert quiet < loud * 0.2  # -20 dB is a 10x amplitude drop


def test_player_guards_window_invariant(mp3):
    from mp3tpu.player import Player
    set_active(Config(decode=DecodeConfig(window_granules=16)))
    with pytest.raises(ValueError, match="window_granules"):
        Player(mp3)


def test_fast_batch_path_obeys_config(mp3):
    """decode_files' fast path takes chunk size / window / plane width
    from the active Config (SURVEY.md §5.6) — non-default values must
    produce identical PCM."""
    from mp3tpu.bitstream import native
    from mp3tpu.pipeline import decode_files
    if not native.available():
        pytest.skip("native unpacker unavailable")
    ref = decode_files([mp3, mp3, mp3])
    set_active(Config(decode=DecodeConfig(
        batch_chunk_streams=2, window_granules=16, plane_bits=8)))
    got = decode_files([mp3, mp3, mp3])
    for (a, sra), (b, srb) in zip(ref, got):
        assert sra == srb
        assert np.array_equal(a, b)


def test_fast_batch_d2h_segments_bit_identical(mp3):
    """The segmented-dispatch D2H-overlap path (d2h_segments > 1)
    threads decode state across segment dispatches, never downloads
    pad windows, and stays bit-identical to the single-dispatch scan."""
    from mp3tpu.bitstream import native
    from mp3tpu.pipeline import decode_files
    if not native.available():
        pytest.skip("native unpacker unavailable")
    ref = decode_files([mp3, mp3])
    # win=16 -> n_win=3, bucket nb=4; segs=2 exercises a trimmed final
    # live segment AND the state carry across the segment boundary
    set_active(Config(decode=DecodeConfig(
        window_granules=16, d2h_segments=2)))
    got = decode_files([mp3, mp3])
    for (a, sra), (b, srb) in zip(ref, got):
        assert sra == srb
        assert np.array_equal(a, b)


def test_fast_batch_memory_cap_falls_back(mp3):
    """A chunk whose staging buffers would exceed batch_max_mb streams
    through the scheduler path instead — same PCM, no fast-path OOM."""
    from mp3tpu.bitstream import native
    from mp3tpu.pipeline import decode_files
    if not native.available():
        pytest.skip("native unpacker unavailable")
    ref = decode_files([mp3, mp3])
    set_active(Config(decode=DecodeConfig(batch_max_mb=0)))  # force slow
    got = decode_files([mp3, mp3])
    for (a, _), (b, _) in zip(ref, got):
        n = min(len(a), len(b))
        assert n > 10000
        d = np.abs(a[:n].astype(np.int32) - b[:n].astype(np.int32))
        assert d.max() <= 1  # scheduler path shares the window partition


def test_fast_batch_cap_counts_full_chunk_width(mp3, monkeypatch):
    """The staging estimate must use the FULL batch_chunk_streams width
    that _fast_chunk actually allocates (fixed jit shapes), not the
    chunk occupancy: a 2-file batch whose 64-wide buffers exceed the cap
    must route through the scheduler without touching the fast path."""
    from mp3tpu import pipeline as pl
    from mp3tpu.bitstream import native
    if not native.available():
        pytest.skip("native unpacker unavailable")
    # 10 MB sits far above the occupancy-based estimate for two short
    # fixtures (<1 MB) and far below the real 64-wide staging (>10 MB)
    set_active(Config(decode=DecodeConfig(batch_max_mb=10)))
    called = []
    monkeypatch.setattr(pl, "_fast_chunk",
                        lambda *a, **k: called.append(1) or False)
    got = pl.decode_files([mp3, mp3])
    assert not called  # the S-wide estimate exceeded the cap
    assert got is not None and len(got) == 2 and len(got[0][0]) > 10000


def test_trace_dir_produces_xplane(mp3, tmp_path, monkeypatch):
    """MP3TPU_TRACE_DIR wraps the decode windows in jax.profiler.trace
    and leaves an XPlane capture on disk."""
    monkeypatch.setenv("MP3TPU_TRACE_DIR", str(tmp_path))
    decode_file(mp3)
    captures = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert captures, "no profiler capture written"
    assert any("xplane" in p.name or p.suffix == ".pb" for p in captures), \
        [p.name for p in captures]


def test_encode_config_reaches_encoder():
    """encode_pcm/encode_batch with no kwargs obey the active
    EncodeConfig (bitrate + noise shaping + device_loops gate)."""
    from mp3tpu.config import EncodeConfig
    from mp3tpu.container import frames as fr
    from mp3tpu.encoder import encode_pcm

    t = np.arange(44100 // 2) / 44100.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * t)
    set_active(Config(encode=EncodeConfig(bitrate=192, noise_shaping=False,
                                          device_loops="off")))
    mp3 = encode_pcm(sig, 44100)
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    # every audio frame carries the configured bitrate (skip Xing frame)
    assert all(h.bitrate == 192000 for h in idx.headers[1:])
    # explicit kwarg still wins over the config
    mp3b = encode_pcm(sig, 44100, bitrate=96)
    idxb = fr.scan_frames(np.frombuffer(mp3b, np.uint8))
    assert all(h.bitrate == 96000 for h in idxb.headers[1:])
    # device_loops="on" must be byte-identical to the explicit kwarg
    import mp3tpu
    set_active(Config(encode=EncodeConfig(device_loops="on")))
    routed_cfg = mp3tpu.encode(sig, 44100)
    routed_kw = encode_pcm(sig, 44100, device_loops=True)
    assert routed_cfg == routed_kw
    # package-level batch API exists and honors the config bitrate
    set_active(Config(encode=EncodeConfig(bitrate=192)))
    outs = mp3tpu.encode_batch([np.stack([sig, sig], 1)], 44100)
    idx2 = fr.scan_frames(np.frombuffer(outs[0], np.uint8))
    assert all(h.bitrate == 192000 for h in idx2.headers[1:])


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir(env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set, and the package sets no
    other directory; unset, a checkout caches in its fixed .jax_cache."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    e = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(repo, ".jax_cache")
    if env == "set":
        want = str(tmp_path / "cache")
        e["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax, mp3tpu; "
            "print(mp3tpu.compile_cache_dir()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=e, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == [want, want]
