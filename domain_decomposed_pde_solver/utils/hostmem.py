"""Host allocator tuning for fault-bound virtual machines.

Measured on a fault-bound cloud VM: first-touch page faults run at
~18 MB/s while writes to already-faulted pages run at ~5 GB/s — a 250x
gap.  glibc serves every large allocation (> M_MMAP_THRESHOLD, default
128 KB) via mmap and munmaps it on free, so EVERY large NumPy temporary
re-pays the fault cost: a fresh ``np.full`` of 144 MB took 7.9 s; the
same allocation after this tuning takes 0.03 s.

:func:`enable_malloc_reuse` raises M_MMAP_THRESHOLD so big buffers come
from the heap arena, where freed memory is reused without returning pages
to the kernel.  Host-side assembly/AMG-setup (allocation-heavy NumPy
pipelines) speed up several-fold.  Trade-off: the process high-water mark
stays allocated (fine on large-RAM hosts); set
``DDPS_NO_MALLOC_TUNING=1`` to opt out.

The reference never hits this because Trilinos pre-allocates its CRS
storage once (``ExodusIO.hpp:418-422``); a NumPy pipeline allocates per
expression.
"""

from __future__ import annotations

import ctypes
import os

_done = False


def enable_malloc_reuse(threshold_bytes: int = 1 << 30) -> bool:
    """Keep allocations below ``threshold_bytes`` on the glibc heap so
    freed buffers are reused without new page faults.  Idempotent; returns
    True if the tuning is active."""
    global _done
    if _done:
        return True
    if os.environ.get("DDPS_NO_MALLOC_TUNING"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, int(threshold_bytes)))
    except Exception:
        return False  # non-glibc platform: nothing to tune
    _done = ok
    return ok
