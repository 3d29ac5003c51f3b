"""Library-indexing throughput: mp3tpu.segment_batch over N streams.

Measures the fused envelope fast path (pipeline._fast_chunk
output="envelope"): C++ window-major unpack + one packed-plane scan
dispatch per chunk + on-device envelope reduction; only [S, G] dB
values cross D2H. Run it alone on the card (one JAX process per GPU).
Prints one JSON line."""
import json
import os
import sys
import time

_R = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_R, "src"))
sys.path.insert(0, os.path.join(_R, "tools"))
sys.path.insert(0, _R)

import numpy as np  # noqa: E402


def main(n_streams: int = 256, seconds: float = 10.0):
    from bench import _fixture_mp3
    import mp3tpu
    data = _fixture_mp3(seconds)
    # distinct byte copies: no accidental caching by identity
    lib = [bytes(data) for _ in range(n_streams)]
    # warmup: compile the scan + envelope programs at bench shapes
    mp3tpu.segment_batch(lib[:2])
    t0 = time.perf_counter()
    segs = mp3tpu.segment_batch(lib)
    wall = time.perf_counter() - t0
    audio = n_streams * seconds
    assert len(segs) == n_streams and all(len(s) >= 1 for s in segs)
    print(json.dumps({
        "metric": "segment_batch_x_realtime", "value": round(audio / wall, 1),
        "unit": "x_realtime_per_chip",
        "detail": {"streams": n_streams, "audio_seconds": audio,
                   "wall_seconds": round(wall, 3),
                   "segments_per_file": len(segs[0]),
                   "first": [list(map(lambda v: round(v, 3), s))
                             for s in segs[0][:3]]}}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
