"""Failure detection / fault injection (SURVEY.md §5.3, §4.3.3):
corrupted streams must never crash, must resync, and must account
errors; chunk-parallel decode must match sequential."""
import numpy as np
import pytest

from mp3tpu.bitstream.unpack import ERR_BAD_DATA, ERR_RESERVOIR, unpack
import importlib
metrics_mod = importlib.import_module("mp3tpu.metrics")
from mp3tpu.container import frames as fr
from mp3tpu.pipeline import decode_file, decode_symbols_chunked, load_symbols

import fixtures


@pytest.fixture(scope="module")
def mp3():
    pytest.importorskip("lameref")
    return fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo")


def test_truncated_stream(mp3):
    pcm, sr = decode_file(mp3[: len(mp3) // 3], gapless=False)
    assert len(pcm) > 10000


def test_midstream_garbage_resyncs(mp3):
    bad = bytearray(mp3)
    lo = len(bad) // 2
    bad[lo:lo + 800] = b"\xaa" * 800   # clobber ~2 frames
    st = unpack(bytes(bad))
    clean = unpack(mp3)
    # must keep most granules and never crash; damaged region flagged
    assert st.n_granules > clean.n_granules - 10
    pcm, _ = decode_file(bytes(bad), gapless=False)
    assert len(pcm) > 50000


def test_random_bytes_rejected():
    rng = np.random.default_rng(0)
    junk = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    with pytest.raises(ValueError):
        decode_file(junk)


def test_chaos_frame_corruption(mp3):
    """Randomly corrupt frames; decode must survive with errors counted."""
    rng = np.random.default_rng(7)
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    bad = bytearray(mp3)
    hit = 0
    for off, h in zip(idx.offsets[2:], idx.headers[2:]):
        if rng.random() < 0.15:
            p = int(off) + 40
            bad[p:p + 30] = rng.integers(0, 256, 30, dtype=np.uint8).tobytes()
            hit += 1
    assert hit > 3
    st = unpack(bytes(bad))
    pcm, _ = decode_file(bytes(bad), gapless=False)
    assert len(pcm) > 50000  # playback never dies mid-stream


def test_reservoir_underflow_mutes():
    """A stream starting mid-file (cut frames) has dangling
    main_data_begin back-pointers: those granules must be muted and
    flagged, not crash."""
    pytest.importorskip("lameref")
    mp3 = fixtures.lame_fixture("transients", ch=2, bitrate=128, mode="jstereo")
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    cut = bytes(mp3[int(idx.offsets[20]):])
    st = unpack(cut)
    assert (st.errors & ERR_RESERVOIR).any()
    # the flagged granules carry no spectrum (muted, not garbage)
    bad = (st.errors & ERR_RESERVOIR) != 0
    assert (st.is_[bad] == 0).all()
    pcm, _ = decode_file(cut, gapless=False)
    assert len(pcm) > 10000


def _global_delta():
    """Context capturing the GLOBAL metrics counter deltas."""
    import contextlib

    @contextlib.contextmanager
    def cm(out: dict):
        before = dict(metrics_mod.GLOBAL.to_dict())
        yield
        after = metrics_mod.GLOBAL.to_dict()
        out.update({k: after[k] - before.get(k, 0)
                    for k in after if isinstance(after[k], (int, float))})
    return cm


def test_muted_mask_matches_taxonomy():
    # metrics mirrors the flag values to avoid a circular import;
    # this pins them together
    assert metrics_mod._ERR_MUTED_MASK == (ERR_RESERVOIR | ERR_BAD_DATA)


def test_error_counters_feed_global(mp3):
    """SURVEY.md §5.3 'error counters increment' / §5.5: decode paths
    feed the process-wide Metrics — a clean decode grows frames_ok
    only; a reservoir-cut stream grows frames_error AND granules_muted
    (VERDICT r3 missing #1: the counters existed but nothing fed them)."""
    cm = _global_delta()
    d = {}
    with cm(d):
        decode_file(mp3, gapless=False)
    assert d["frames_ok"] > 0 and d["frames_error"] == 0
    assert d["granules_muted"] == 0 and d["resyncs"] == 0

    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    cut = bytes(mp3[int(idx.offsets[20]):])   # dangling back-pointers
    d = {}
    with cm(d):
        decode_file(cut, gapless=False)
    assert d["frames_error"] > 0 and d["granules_muted"] > 0


def test_metadata_frame_not_counted(mp3):
    """The leading Xing/Info frame carries no audio: the frame books
    count only audio frames, matching the batch fast path (which strips
    the metadata frame's bytes before unpacking)."""
    full = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    d = {}
    with _global_delta()(d):
        _st, _info, index = load_symbols(mp3)
    assert len(index.offsets) == len(full.offsets) - 1  # Info frame cut
    assert d["frames_ok"] + d["frames_error"] == len(index.offsets)


def test_batch_books_match_singles(mp3):
    """decode_files counts each stream's faults exactly once, and the
    totals equal the single-file path's for the same bytes (no per-path
    drift, no double booking on fast/fallback boundaries)."""
    from mp3tpu.pipeline import decode_files
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    cut = bytes(mp3[int(idx.offsets[20]):])
    d_single: dict = {}
    with _global_delta()(d_single):
        decode_file(mp3, gapless=False)
        decode_file(cut, gapless=False)
    d_batch: dict = {}
    with _global_delta()(d_batch):
        decode_files([mp3, cut], gapless=False)
    for k in ("frames_ok", "frames_error", "granules_muted", "resyncs"):
        assert d_batch[k] == d_single[k], (k, d_batch, d_single)


def test_player_replay_counts_once():
    """Repeat-listening (the reference's core gesture) replays the same
    granules many times; the books count each granule ONCE per player —
    re-unpacking an evicted group must not re-record its faults."""
    pytest.importorskip("lameref")
    mp3 = fixtures.lame_fixture("transients", ch=2, bitrate=128,
                                mode="jstereo")
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    cut = bytes(mp3[int(idx.offsets[20]):])
    from mp3tpu.player import Player
    p = Player(cut, apply_gapless=False)
    p.play()
    once = (p.metrics.frames_ok, p.metrics.frames_error,
            p.metrics.granules_muted)
    assert once[1] > 0 and once[2] > 0
    p.seek(0.0)
    p.play()   # full replay re-unpacks every evicted group
    assert (p.metrics.frames_ok, p.metrics.frames_error,
            p.metrics.granules_muted) == once


def test_resync_counter_feeds_global(mp3):
    bad = bytearray(mp3)
    lo = len(bad) // 2
    bad[lo:lo + 800] = b"\xaa" * 800
    idx = fr.scan_frames(np.frombuffer(bytes(bad), np.uint8))
    assert idx.resyncs >= 1          # the scanner saw a mid-stream junk run
    clean_idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    assert clean_idx.resyncs == 0    # clean stream: none
    d = {}
    with _global_delta()(d):
        decode_file(bytes(bad), gapless=False)
    assert d["resyncs"] >= 1


def test_scheduler_error_counters(mp3):
    """The scheduler's local Metrics accounts faults per stream window
    (the operator surface the soak asserts — SURVEY.md §5.3)."""
    from mp3tpu.player import StreamScheduler
    from mp3tpu.player.sink import CollectSink
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    cut = bytes(mp3[int(idx.offsets[20]):])
    sched = StreamScheduler(n_slots=2, win=32, sample_rate=44100)
    sched.submit(mp3, sink=CollectSink(), stream_id=0)
    sched.submit(cut, sink=CollectSink(), stream_id=1)
    sched.run()
    m = sched.metrics
    assert m.frames_error > 0 and m.granules_muted > 0
    assert m.frames_ok > 0
    assert m.streams_finished == 2


def test_player_error_counters():
    pytest.importorskip("lameref")
    mp3 = fixtures.lame_fixture("transients", ch=2, bitrate=128,
                                mode="jstereo")
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    cut = bytes(mp3[int(idx.offsets[20]):])
    from mp3tpu.player import Player
    p = Player(cut, apply_gapless=False)
    p.play()
    assert p.metrics.frames_error > 0 and p.metrics.granules_muted > 0


def test_sink_underruns_aggregate(mp3):
    """Sink-level starvation counts roll up into Metrics.underruns
    (VERDICT r3: RingBuffer.underruns never aggregated)."""
    from mp3tpu.player import Player
    from mp3tpu.player.sink import CollectSink

    class StarvingSink(CollectSink):
        def __init__(self):
            super().__init__()
            self.underruns = 0

    snk = StarvingSink()
    p = Player(mp3, sink=snk, apply_gapless=False)
    p.play(max_samples=32 * 576)
    assert p.metrics.underruns == 0
    snk.underruns = 3                 # consumer starved 3 times
    p.play(max_samples=32 * 576)
    assert p.metrics.underruns == 3
    p.play()                          # no further starvation: no growth
    assert p.metrics.underruns == 3


def test_chunk_parallel_matches_sequential(mp3):
    st, _info, _ = load_symbols(mp3)
    ref, _ = decode_file(mp3, gapless=False)
    par = decode_symbols_chunked(st, chunk_granules=32, halo=2)
    from mp3tpu.kernels.pipeline import quantize_i16
    import jax.numpy as jnp
    par16 = np.asarray(quantize_i16(jnp.asarray(par)))
    n = min(len(ref), len(par16))
    d = np.abs(ref[:n].astype(np.int32) - par16[:n].astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() > 0.999
    # the fused int16 output (quantize inside the dispatch, one 4x
    # smaller download) honors the same <=1 LSB contract; XLA may fuse
    # the combined program's float math differently than the float-only
    # program (observed: identical on CPU, a few samples 1 LSB off on
    # accelerator backends)
    par16_dev = decode_symbols_chunked(st, chunk_granules=32, halo=2,
                                       output="int16")
    dd = np.abs(par16_dev.astype(np.int32) - par16.astype(np.int32))
    assert dd.max() <= 1 and (dd == 0).mean() > 0.999


def test_batch_fast_path_chaos_all_kinds(mp3):
    """VERDICT r4 task 8 / SURVEY.md §5.3: the packed-plane batch fast
    path under ALL THREE soak corruption kinds (byte flips, reservoir
    cut, header kill). For every stream, decode_files' output must
    match the single-file decode <=1 LSB (the shared-program muting
    contract — or, if the chunk fell back, the scheduler path's books),
    and the GLOBAL fault counters must grow by exactly the single-path
    totals (pending_faults commits once, no double booking)."""
    from soak import _CORRUPTIONS
    from mp3tpu.pipeline import decode_files
    rng = np.random.default_rng(11)
    streams = [mp3]
    for _name, fn in _CORRUPTIONS:
        streams.append(fn(mp3, rng))
    streams.append(mp3)                      # clean tail stream
    singles = []
    d_single: dict = {}
    with _global_delta()(d_single):
        for s in streams:
            singles.append(decode_file(s, gapless=False))
    assert d_single["frames_error"] > 0      # flips really corrupted
    assert d_single["granules_muted"] > 0    # cut really underflowed
    assert d_single["resyncs"] > 0           # header kill really lost sync
    d_batch: dict = {}
    with _global_delta()(d_batch):
        outs = decode_files(streams, gapless=False)
    for k in ("frames_ok", "frames_error", "granules_muted", "resyncs"):
        assert d_batch[k] == d_single[k], (k, d_batch, d_single)
    for (ref, rsr), (got, gsr) in zip(singles, outs):
        assert gsr == rsr
        got = np.asarray(got)
        assert got.shape == np.asarray(ref).shape
        d = np.abs(np.asarray(ref).astype(np.int32) - got.astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() > 0.97


def test_batch_fast_path_decodes_corruption_in_path(mp3):
    """Flip + header-kill corruption stays ON the packed-plane fast
    path (only the reservoir-cut kind trips the metadata-strip guard
    into the scheduler fallback): assert the fast path really ran,
    muted identically to single decode, and booked the exact counts."""
    from soak import _corrupt_flip, _corrupt_header
    from mp3tpu import pipeline
    rng = np.random.default_rng(23)
    streams = [mp3, _corrupt_flip(mp3, rng), _corrupt_header(mp3, rng)]
    singles = []
    d_single: dict = {}
    with _global_delta()(d_single):
        for s in streams:
            singles.append(decode_file(s, gapless=False))
    d_batch: dict = {}
    with _global_delta()(d_batch):
        outs = pipeline._decode_files_fast(streams, False)
    assert outs is not None, "corruption knocked the batch off the fast path"
    for k in ("frames_ok", "frames_error", "granules_muted", "resyncs"):
        assert d_batch[k] == d_single[k], (k, d_batch, d_single)
    assert d_batch["frames_error"] > 0 and d_batch["resyncs"] > 0
    for (ref, rsr), (got, gsr) in zip(singles, outs):
        assert gsr == rsr
        got = np.asarray(got)
        d = np.abs(np.asarray(ref).astype(np.int32) - got.astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() > 0.97
