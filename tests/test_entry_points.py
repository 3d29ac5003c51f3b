"""The GPU entry scripts refuse to run anywhere else: without a GPU they
exit non-zero, run none of their work on the CPU, and print no result."""
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "bench_configs.py",
                                    "tools/gpu_encode_timing.py"])
def test_refuses_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(_REPO, script)],
                         env=env, cwd=_REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr
