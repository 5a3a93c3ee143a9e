"""repro_torch — the PyTorch/CUDA port of ``repro`` (the JAX reference).

Module and function names mirror the reference so each counterpart is easy
to find.  Backends: ``numpy`` (scalar per-row oracle on the host),
``torch`` (the batched plain PyTorch path) and ``cuda`` (the same path with
the hand-written kernels of ``repro_torch.kernels``).  The device policy is
``repro_torch.kernels.runtime``: CUDA unless the caller asks for the CPU.
"""
