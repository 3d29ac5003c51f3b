"""GPU timings behind encode_pcm's routing threshold (PERF.md, Findings).

    python tools/gpu_encode_timing.py

Single-stream encode_pcm of one stereo 128 kbps stream at 0.05 s to 10 s,
through the host f64 path (device_loops=False) and the B=1 device batch
path (device_loops=True). The device path compiles once per 64-granule
bucket of the stream's length, so "cold" is the first call of a length in
the process (compile included, or read from the persistent cache) and
"warm" the next one. Run it twice with the same JAX_COMPILATION_CACHE_DIR:
in the second run, the first device call shows what a new process pays
once the cache holds the programs; later lengths pay only their bucket.

Each line is JSON with the card's name and power limit. Needs a GPU:
exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "src"))
sys.path.insert(0, _REPO)

SR = 44100
SECONDS = (0.05, 0.1, 0.25, 0.5, 1.0, 1.5, 3.0, 10.0)


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def routing(card: str, signals):
    from mp3tpu.encoder import ENCODER_DELAY, SPF, encode_pcm
    paths = {"host": False, "device_loops": True}
    for seconds in SECONDS:
        x = signals(1, seconds)[0]
        G = -(-(len(x) + ENCODER_DELAY + 529) // SPF)
        G += G & 1
        for name, loops in paths.items():
            run = lambda: encode_pcm(x, SR, bitrate=128, device_loops=loops)
            cold = _timed(run)
            warm = _timed(run)
            print(json.dumps({
                "timing": "encode_pcm_routing", "seconds": seconds,
                "granules": G, "bucket": -(-G // 64) * 64, "path": name,
                "cold_s": cold, "warm_s": warm, "card": card}), flush=True)


def main() -> int:
    import jax
    if jax.devices()[0].platform != "gpu":
        print("gpu_encode_timing: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke
    smoke = chip_smoke.Smoke(0, 0.0, seed=0)
    routing(smoke.card, smoke.signals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
