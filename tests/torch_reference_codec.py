"""Builds the JAX package's native codec once per checkout, before any test
loads it.

The reference's ``imageio._build_native`` runs ``make`` in place, and its
Makefile writes ``csrc/libirpimageio.so`` directly (``-o $@``). Under
pytest-xdist another worker's ``_load_native`` can find that file while
``g++`` is still writing it; ``ctypes.CDLL`` then fails ("file too short")
and that worker falls back to Pillow for the rest of the run, so tests that
compare against the native codec fail on a fresh tree only.

``build_reference_codec()`` is called at module level by the port's test
files that reach the reference codec: every xdist worker collects the whole
suite before it runs a test, and no test module loads the codec while it is
collected. Under a lock on ``build/reference_codec.lock`` (one process at a
time, across processes) it builds the library with the reference's own
Makefile, sources and flags into a directory of its own under ``build/``,
then renames it into ``image_restoration_platform_tpu/imageio/csrc/``: a
reader finds either no file or the whole library. The result is the same
git-ignored file the reference's first use leaves. Where the build fails
(no toolchain), nothing is written and the reference falls back to Pillow
as it would alone.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "image_restoration_platform_tpu", "imageio", "csrc")
LIBRARY = "libirpimageio.so"
BUILD = os.path.join(ROOT, "build")


def build_reference_codec() -> bool:
    """Build ``csrc/libirpimageio.so`` of the reference if it is absent;
    True when the library is there afterwards."""
    target = os.path.join(CSRC, LIBRARY)
    if os.path.exists(target):
        return True
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "reference_codec.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(target):  # another process built it meanwhile
            return True
        scratch = os.path.join(BUILD, f"reference_codec.{os.getpid()}")
        os.makedirs(scratch, exist_ok=True)
        try:
            # the reference's rule, run in the scratch directory: VPATH finds
            # imageio.cpp in csrc/, and $@ is the scratch directory's file
            subprocess.run(["make", "-s", "-C", scratch, "-f", os.path.join(CSRC, "Makefile"), f"VPATH={CSRC}",
                            LIBRARY], check=True, capture_output=True, timeout=180)
            os.replace(os.path.join(scratch, LIBRARY), target)
        except (OSError, subprocess.SubprocessError):
            return False
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return True
