"""Build the native library: ``python -m volumerenderingproject.native.build``."""

from __future__ import annotations

import os
import subprocess
import sys


def build(verbose: bool = True) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = ["make", "-C", here]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if verbose:
        sys.stdout.write(result.stdout)
        sys.stderr.write(result.stderr)
    if result.returncode != 0:
        raise RuntimeError(f"native build failed (rc={result.returncode})")
    return os.path.join(here, "libvrputils.so")


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
