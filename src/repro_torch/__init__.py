"""PyTorch/CUDA port of the licensed serving system.

A second package beside the JAX reference ``repro``, with the same
sub-package layout (``configs``, ``core``, ``kernels``, ``models``,
``serving``, ``launch``) and names, so each module's counterpart is easy
to find.  It imports torch and never jax, and nothing of ``repro``.
Entry points run on a CUDA device unless the caller passes another;
every TPU kernel on the ported path has a hand-written Hopper kernel
(``kernels/``) beside its plain PyTorch version.
"""
