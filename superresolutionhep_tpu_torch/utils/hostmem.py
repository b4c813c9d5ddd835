"""Host allocator tuning for the host-side buffer churn of training and
inference.

Every step allocates fresh multi-MB host buffers (collated batches, staging
copies to the device, the CPU path's temporaries).  glibc's default dynamic
mmap threshold serves them with mmap/munmap pairs, so every step re-faults its
working set page by page.  Pinning the thresholds high keeps a stable,
pre-faulted heap that the steps reuse.

The tunables must be in the ENVIRONMENT BEFORE the process starts: glibc sizes
its arenas at startup, and ``mallopt()`` after import recovers only a part.
Hence ``ensure_tuned()`` re-execs the interpreter once with the tunables set
when they are missing; call it at the top of an entry point.

The port's copy of the JAX package's ``utils/hostmem.py``, with the same
tunables and the same no-op rules.  It changes no setting of the machine
(the JAX copy also switches transparent huge pages on under ``/sys`` when it
runs as root; this one does not), and it re-execs a ``python -m
superresolutionhep_tpu_torch...`` invocation as well as a script.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

_VARS = {
    # serve large buffers from the heap and never trim it back: the steady
    # state is a stable, pre-faulted arena reused across steps (peak RSS is
    # bounded by the largest live working set, not the sum)
    "MALLOC_MMAP_THRESHOLD_": str(1 << 30),
    "MALLOC_TRIM_THRESHOLD_": str(1 << 30),
    # one arena: worker threads otherwise allocate from non-main arenas whose
    # 64 MB heaps are mapped and released independently of the trim threshold
    "MALLOC_ARENA_MAX": "1",
}


def reexec_argv() -> Optional[List[str]]:
    """The argv that starts this process again, or None where it cannot be
    reproduced.  ``sys.orig_argv`` keeps the interpreter's own flags (``-O``,
    ``-W``, ``-X`` ...) and the ``-m <module>`` that ``sys.argv`` drops: under
    ``-m``, ``sys.argv[0]`` is the module's file, and running that file as a
    script would break its relative imports.  ``-c`` and the REPL cannot be
    reproduced (``sys.argv[0]`` is ``-c`` or empty there)."""
    orig = list(getattr(sys, "orig_argv", None) or [])
    if len(orig) < 2 or not sys.argv or not sys.argv[0].endswith(".py"):
        return None
    # orig_argv[0] may be a bare 'python': exec sys.executable (an absolute path)
    return [sys.executable] + orig[1:]


def ensure_tuned() -> None:
    """Re-exec the interpreter with glibc malloc tunables set (no-op if they
    are already in the environment, on non-Linux, or under pytest)."""
    if sys.platform != "linux" or "pytest" in sys.modules:
        return
    if all(v in os.environ for v in _VARS):
        return
    argv = reexec_argv()
    if argv is None:
        return
    for k, v in _VARS.items():
        # setdefault: a tunable the user set (e.g. MALLOC_ARENA_MAX=4 to
        # measure arena behaviour) wins over ours
        os.environ.setdefault(k, v)
    try:
        os.execv(sys.executable, argv)
    except OSError:  # an exotic launcher: keep running untuned rather than die
        pass
