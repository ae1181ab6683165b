"""Build the port's CUDA kernels from the sources under ``csrc/`` at first use.

All ``.cu`` files and the one binding file go to a single
``torch.utils.cpp_extension.load`` call (ninja compiles them in
parallel) for ``sm_90a``; the objects and the loaded module land in
``build/torch_kernels/`` at the repository root, which ``.gitignore``
lists.  Nothing here runs at import time: the CPU tests import every
module of the port on a machine with no CUDA compiler.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Any

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
# Link the shared libstdc++ that torch's process already holds.  A compiler
# named by $CXX that links its own libstdc++ statically puts a second copy of
# the iostream and locale code in the module; its facet ids then index the
# process's locales wrongly, and the first integer streamed into a message
# (c10::str, so any failing TORCH_CHECK that formats one) ends the process
# with SIGSEGV instead of raising.
LINK_FLAGS = ["-Wl,--push-state,-Bdynamic,-l:libstdc++.so.6,--pop-state"]


@functools.lru_cache(maxsize=None)
def load_extension() -> Any:
    """Compile (or reuse the build of) the CUDA kernels; returns the module."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in CSRC.glob("*.cu")) + [str(CSRC / "bindings.cpp")]
    return load(name="repro_torch_kernels", sources=sources,
                build_directory=str(BUILD_DIR), extra_cflags=["-O2"],
                extra_cuda_cflags=["-O3", *ARCH_FLAGS], extra_ldflags=LINK_FLAGS)

