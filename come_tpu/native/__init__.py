"""Native host-side components (C++ via ctypes).

Exactly one native component exists in the reference (the Cython SGD loop,
SURVEY.md C1) and its replacement is the batched device path; the native
component that *is* justified host-side (SURVEY.md §7 hard part 4) is the
corpus feeder: multithreaded C++ walk generation for graphs kept in host
memory, double-buffered against device training.
"""

from come_tpu.native.build import load_native, native_available
from come_tpu.native.walker import host_random_walks, HostWalkFeeder

__all__ = [
    "load_native",
    "native_available",
    "host_random_walks",
    "HostWalkFeeder",
]
