"""Phase decomposition of config-5 single-stream encode (VERDICT r4 #6).

Runs the exact bench_configs config-5-single workload (public
encode_pcm, 10 s int16-origin chirp, 128 kbps) with
MP3TPU_ENCODE_PROFILE=1 and prints the per-phase walls plus the
derived floor split: what is fixed pipeline latency (dispatch count),
what is MACRO-row padding waste at B=1, and what is host mux. Run it
alone on the card (one JAX process per GPU). One JSON line.
"""
import json
import os
import sys
import time

_R = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_R, "src"))
sys.path.insert(0, os.path.join(_R, "tools"))
sys.path.insert(0, _R)
os.environ["MP3TPU_ENCODE_PROFILE"] = "1"

import numpy as np


def main(reps: int = 3, seconds: float = 10.0):
    from bench_configs import _signal
    from mp3tpu.encoder import encode_pcm
    import mp3tpu.encoder.batch as eb

    pcm = _signal(seconds)
    pcmq = np.round(np.clip(pcm, -0.99, 0.99) * 32768.0) / 32768.0

    encode_pcm(pcmq, 44100, bitrate=128)   # warm compile
    walls, phases = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = encode_pcm(pcmq, 44100, bitrate=128)
        walls.append(time.perf_counter() - t0)
        phases.append(dict(getattr(eb, "LAST_PROFILE", {}) or {}))
    best = min(range(reps), key=lambda i: walls[i])
    print(json.dumps({
        "metric": "encode_single_profile",
        "audio_s": seconds,
        "walls_s": [round(w, 3) for w in walls],
        "x_best": round(seconds / min(walls), 1),
        "phases_best": {k: round(v, 4) for k, v in phases[best].items()},
        "mp3_bytes": len(out),
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
