"""Device policy and the CUDA kernel library for the port's kernel packages.

**Device policy.**  Every batched path runs on one ``torch.device``,
resolved in this order (the port's counterpart of
``repro.kernels.runtime.resolve_interpret``):

1. an explicit ``device=`` argument always wins;
2. else the ``REPRO_TORCH_DEVICE`` environment variable (``cpu``,
   ``cuda``, ``cuda:1``, ...).  Child processes inherit it, so exporting it
   is also the blanket worker-side override;
3. else the process default: ``cuda``, unless a driver seeded another one
   with ``seed_platform_default``.

Resolution is lazy and never touches CUDA: engines store the *unresolved*
argument and resolve it on their first dispatch, so constructing one (for
example in a freshly spawned worker) initialises nothing.  When the
resolved device is ``cuda`` and no card is present, ``require_device``
raises at that first dispatch; nothing falls back to the CPU.

**Kernel library.**  The hand-written kernels (``csrc/*.cu``) build on first
use into one shared library with a plain C interface under ``build/`` at the
repository root: one ``nvcc -c`` per source, all started together, then one
link.  The file name carries a hash of the sources, so an edited source
rebuilds and a stale library is never loaded.  ``load_library`` returns the
``ctypes`` handle with every entry point's ``argtypes``/``restype`` set.
Each entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.

**Gradients.**  The reference's Pallas kernels are forward-only (no
``custom_vjp``, no backward kernel; it trains through its jnp paths), so
the port's kernels have no backward kernel either.  ``plain_vjp`` is the
backward their ``torch.autograd.Function`` routes share: it recomputes the
kernel's plain version from the saved inputs and differentiates that, the
reference's ``remat="full"`` in kernel form.

**Shape-only calls.**  A host-side trace of the card's step
(``launch.dryrun``) runs the model on ``FakeTensor``s, which hold no
memory.  ``is_fake`` tells a wrapper so; the wrapper then makes its checks,
allocates its outputs and calls ``shape_only`` with the kernel's name,
operations and bytes in place of the launch; ``shape_only`` hands them
to every callable in ``SHAPE_ONLY_HOOKS`` (the tracer's).  No library is
loaded and no launch counter moves.  A fake operand may lie on the meta
device in place of a card's (``require_card``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

__all__ = [
    "ENV_VAR",
    "SHAPE_ONLY_HOOKS",
    "check",
    "default_device",
    "is_fake",
    "plain_vjp",
    "load_library",
    "platform_default_hint",
    "require_device",
    "require_card",
    "require_local",
    "resolve_device",
    "seed_platform_default",
    "shape_only",
]

ENV_VAR = "REPRO_TORCH_DEVICE"

# Seeded process default (None = the built-in "cuda").  Module state so a
# transport driver can hand its workers the parent's policy.
_PLATFORM: Optional[str] = None

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# nvcc's default math flags, as PyTorch's own kernels build: the kernels'
# arithmetic uses explicit round-to-nearest intrinsics (csrc/common.cuh).
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argtypes (every pointer and the stream as c_void_p, a
# float as c_float).
_SIGNATURES = {
    "changepoint_scan": [_P] * 3 + [_I] * 4 + [_P] * 3 + [_I, _I, _P],
    "windowvet_fused": [_P] * 5 + [_I, _I, _I, _I, _P],
    "ssd_scan_f32": [_P] * 8 + [_I] * 7 + [_P],
    "ssd_scan_bf16": [_P] * 8 + [_I] * 7 + [_P],
    "ssd_scan_smem_bytes": [_I] * 4,
    "flash_attention_f32": [_P] * 4 + [_I] * 7 + [_F, _P],
    "flash_attention_bf16": [_P] * 4 + [_I] * 7 + [_F, _P],
    "flash_attention_wide_f32": [_P] * 4 + [_I] * 8 + [_F, _P],
    "flash_attention_wide_bf16": [_P] * 4 + [_I] * 8 + [_F, _P],
}
_LIB = None
# callables (name, operations, bytes) that ``shape_only`` notifies
SHAPE_ONLY_HOOKS: list = []


def seed_platform_default(device: Optional[str]) -> None:
    """Install a process default device without touching CUDA (what a
    driver forwards to its workers).  ``None`` leaves the built-in default;
    ``REPRO_TORCH_DEVICE`` still wins over the seed."""
    global _PLATFORM
    if device is not None:
        _PLATFORM = str(torch.device(device))


def platform_default_hint() -> Optional[str]:
    """This process's seeded default, or ``None`` if never seeded."""
    return _PLATFORM


def default_device() -> torch.device:
    """The process-wide default: environment override, else the seed, else
    ``cuda``."""
    env = os.environ.get(ENV_VAR)
    if env is not None and env.strip():
        return torch.device(env.strip())
    return torch.device(_PLATFORM or "cuda")


def resolve_device(device=None) -> torch.device:
    """Resolve a ``device=`` argument (``None`` = the process default)."""
    return default_device() if device is None else torch.device(device)


def require_device(device: torch.device) -> torch.device:
    """Raise when ``device`` is a CUDA device this process cannot use."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            f"pass device='cpu' or set {ENV_VAR}=cpu to run on the CPU")
    return device


def require_local(name: str, *tensors) -> None:
    """Raise when a kernel wrapper is handed a DTensor.

    A kernel reads raw pointers of one device's memory, so it takes each
    rank's local shard (``models.layers`` calls it through ``local_map``);
    it neither unwraps a DTensor nor swaps in its plain version for one.

    Raises:
        TypeError: one of ``tensors`` is a DTensor.
    """
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, got a DTensor; call "
                        f"it on each rank's shard (local_map)")


def plain_vjp(plain_fn, inputs, needs_grad, grad_out, label: str):
    """Input gradients of ``plain_fn(*inputs)`` against ``grad_out``: the
    plain version recomputed from the saved ``inputs`` under autograd, one
    gradient (or ``None``) per input as ``needs_grad`` asks.  The work runs
    under a ``torch.profiler`` range named ``label``, so a trace sets the
    plain backward apart from the kernel's forward."""
    with torch.enable_grad(), torch.profiler.record_function(label):
        ins = [t.detach().requires_grad_(bool(need))
               for t, need in zip(inputs, needs_grad)]
        out = plain_fn(*ins)
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(got) if need else None for need in needs_grad)


def is_fake(*tensors) -> bool:
    """Whether every one of ``tensors`` is a ``FakeTensor`` (shapes,
    dtypes and a device, no memory)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return all(isinstance(t, FakeTensor) for t in tensors)


def require_card(name: str, device: torch.device, fake: bool) -> None:
    """Raise unless a kernel's operands lie on ``device`` where it runs: a
    CUDA device, or, for fake operands, the meta device, which a host
    trace without the card uses in its place.

    Raises:
        ValueError: another device.
    """
    if device.type != "cuda" and not (fake and device.type == "meta"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {device}")


def shape_only(name: str, ops: float, nbytes: float) -> None:
    """Report a kernel call that a wrapper made on fake tensors (in place
    of the launch) to each of ``SHAPE_ONLY_HOOKS``."""
    for hook in tuple(SHAPE_ONLY_HOOKS):
        hook(name, ops, nbytes)


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error (a
    ``cudaError_t`` value; see ``cuda_runtime_api.h``)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on first use "
                       "and need the CUDA toolkit on PATH or CUDA_HOME")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where this checkout's sources build to (content-hashed name)."""
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a into the shared library (if absent).

    Raises:
        RuntimeError: nvcc is missing or any compile/link step fails (the
            message carries nvcc's stderr).
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for src, proc in zip(_sources(), procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{err}")
    if errors:
        raise RuntimeError("nvcc failed to build the kernel library:\n"
                           + "\n".join(errors))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernel library:\n"
                           f"{link.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial
    return out


def load_library():
    """The ``ctypes`` handle of the kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
