"""Build, load and launch the port's hand-written CUDA kernels.

Every source under `robogym_torch/csrc/` is compiled for `sm_90a` by its own
`nvcc` process, all started together, and the objects are linked into one
shared library with a plain C interface, which is loaded with `ctypes`. The
build happens at the first launch in a process (or at an explicit
`build()`), into `build/kernels/` at the root of the checkout; a library
whose sources, headers and flags are unchanged is reused.

`launch(name, *args)` calls the C entry point `robogym_<name>` with each
tensor's data pointer (None: a null pointer) and each int as a C int, on
PyTorch's current stream,
raises if the launch returns a CUDA error, and then adds one to
`LAUNCHES[name]`. Nothing else changes the counts, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "kernels")
SOURCES = ("spd_inverse.cu", "cg_full.cu", "cg.cu", "hull_sweep.cu", "boxbox.cu")
HEADERS = ("cg_common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: float32 expressions round as PyTorch's elementwise operations
# do, so the hull kernels pick the plain version's directions and the
# box-box kernel its SAT axis
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

# C entry points `robogym_<name>`: (device pointers, ints) before the stream
SIGNATURES = {"spd_inverse": (2, 2), "cg_full": (29, 7), "cg_full_noeuler": (24, 6),
              "cg": (14, 4), "hull_pair": (14, 5), "hull_manifold": (13, 5),
              "hull_pair_world": (10, 5), "hull_manifold_world": (9, 5), "boxbox": (9, 1)}
LAUNCHES = {name: 0 for name in SIGNATURES}
MAX_V = 256   # dofs a CG kernel takes (eight a lane of one warp)
# exports that describe the CG kernels' layouts: name, argument count
_SIZES = (("max_smem_bytes", 0), ("cg_smem_bytes", 2), ("cg_scratch_floats", 2),
          ("cg_full_smem_bytes", 3), ("cg_trace_floats", 2))
_OCCUPANCY = (("cg_blocks_per_sm", 2), ("cg_full_blocks_per_sm", 3))

_lock = threading.Lock()
_lib = None
_build_log = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return path


def _compile(srcs, lib: str) -> str:
    """One `nvcc -c` per source, all running at once, then one link into
    `lib`; returns the compilers' reports."""
    tmp = f"{lib}.{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for s, o in zip(srcs, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    try:
        failed = [s for s, p in zip(srcs, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", tmp + ".so", *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp + ".so", lib)
    return log


def build() -> str:
    """Compile and load the kernel library once per process; returns the
    report of `nvcc -Xptxas -v` (registers, shared memory, spills)."""
    global _lib, _build_log
    with _lock:
        if _lib is not None:
            return _build_log
        srcs = [os.path.join(CSRC, s) for s in SOURCES]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs + [os.path.join(CSRC, x) for x in HEADERS]:
            with open(s, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib = os.path.join(BUILD_DIR, f"librobogym_kernels_{h.hexdigest()[:16]}.so")
        log = lib[:-3] + ".log"
        if not (os.path.exists(lib) and os.path.exists(log)):
            text = _compile(srcs, lib)
            with open(log + f".{os.getpid()}.tmp", "w") as f:
                f.write(text)
            os.replace(log + f".{os.getpid()}.tmp", log)
        with open(log) as f:
            _build_log = f.read()
        _lib = ctypes.CDLL(lib)
        _lib.robogym_error_string.restype = ctypes.c_char_p
        _lib.robogym_error_string.argtypes = [ctypes.c_int]
        for name, n in _SIZES + _OCCUPANCY:
            fn = getattr(_lib, "robogym_" + name)
            fn.restype = ctypes.c_longlong if (name, n) in _SIZES else ctypes.c_int
            fn.argtypes = [ctypes.c_int] * n
        for name, (n_ptr, n_int) in SIGNATURES.items():
            fn = getattr(_lib, "robogym_" + name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return _build_log


@functools.lru_cache(maxsize=None)
def _size(name: str, *args: int) -> int:
    build()
    return int(getattr(_lib, "robogym_" + name)(*args))


def max_smem_bytes() -> int:
    """Shared memory one block of a CG kernel may use (227 KB on Hopper),
    the limit of kernel B's layout."""
    return _size("max_smem_bytes")


def cg_smem_bytes(E: int, V: int) -> int:
    """Dynamic shared memory of one env (one block) of kernel F (`cg`) for
    E rows and V dofs, on the route it takes."""
    return _size("cg_smem_bytes", E, V)


def cg_scratch_floats(E: int, V: int) -> int:
    """Floats of device scratch an env of kernel F takes for E rows and V
    dofs: 0 where J fits in shared memory, else its row forces and spilled
    rows (J in device memory)."""
    return _size("cg_scratch_floats", E, V)


def cg_trace_floats(V: int, E: int) -> int:
    """Floats of one slot of a CG kernel's trace (B and F) for V dofs and
    E rows: x, jar, the search direction, g and M^-1 g, the pick and beta."""
    return _size("cg_trace_floats", V, E)


def cg_full_smem_bytes(E: int, V: int, euler: bool) -> int:
    """Dynamic shared memory of one env (one block) of kernel B
    (`cg_full` with `euler`, else `cg_full_noeuler`) for E rows and V
    dofs."""
    return _size("cg_full_smem_bytes", E, V, int(euler))


def _blocks_per_sm(name: str, *args: int) -> int:
    build()
    n = int(getattr(_lib, "robogym_" + name)(*args))
    if n < 0:
        raise RuntimeError(f"{name}{args}: CUDA error {-n} "
                           f"({_lib.robogym_error_string(-n).decode()})")
    return n


def cg_blocks_per_sm(E: int, V: int) -> int:
    """Envs of kernel F (`cg`) resident on one SM for E rows and V dofs, by
    the CUDA occupancy calculator; raises on a CUDA error."""
    return _blocks_per_sm("cg_blocks_per_sm", E, V)


def cg_full_blocks_per_sm(E: int, V: int, euler: bool) -> int:
    """Envs of kernel B (`cg_full` with `euler`, else `cg_full_noeuler`)
    resident on one SM for E rows and V dofs, by the CUDA occupancy
    calculator; raises on a CUDA error."""
    return _blocks_per_sm("cg_full_blocks_per_sm", E, V, int(euler))


def spd_inverse_info(V: int) -> dict:
    """The layout of kernel A (`spd_inverse`) at V dofs: shared memory a
    block, registers a thread, blocks an SM (the occupancy calculator),
    envs a block, rows a lane (0 above 64 dofs), warps a block and the
    route: "registers" (one warp an env up to 64 dofs), "shared" (one env a
    block of warps, the matrix in shared memory) or "device" (the same in
    device memory), and the largest V whose matrix the build holds in
    shared memory ("max_smem_v"). A field that an older build does not
    report is -1 (the route None); raises on a CUDA error."""
    build()
    fn = _lib.robogym_spd_inverse_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)(*[-1] * 8)  # an older build leaves the fields it lacks at -1
    rc = fn(V, out)
    if rc:
        raise RuntimeError(f"spd_inverse_info: CUDA error {rc} "
                           f"({_lib.robogym_error_string(rc).decode()})")
    info = dict(zip(("smem_bytes", "registers", "blocks_per_sm", "envs_per_block",
                     "rows_per_lane", "warps_per_block"), out))
    info["route"] = {0: "registers", 1: "shared", 2: "device"}.get(out[6])
    info["max_smem_v"] = out[7]
    return info


HULL_KINDS = ("hull_manifold", "hull_manifold_world", "hull_pair", "hull_pair_world")


def hull_info(name: str, V1: int, V2: int, DX: int) -> dict:
    """The layout of hull kernel `name` (one of `HULL_KINDS`: C, H, D, G)
    for V1 and V2 verts a side and DX extra directions: shared memory a
    block, registers a thread, blocks an SM (the occupancy calculator),
    threads and pairs a block; raises on a CUDA error."""
    build()
    fn = _lib.robogym_hull_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(HULL_KINDS.index(name), V1, V2, DX, out)
    if rc:
        raise RuntimeError(f"hull_info({name}): CUDA error {rc} "
                           f"({_lib.robogym_error_string(rc).decode()})")
    return dict(zip(("smem_bytes", "registers", "blocks_per_sm", "threads", "pairs_per_block"),
                    out))


def boxbox_info() -> dict:
    """The layout of the box-box kernel (E): lanes a pair, pairs and
    threads a block, shared memory a block, registers a thread and blocks
    an SM (the occupancy calculator); raises on a CUDA error."""
    build()
    fn = _lib.robogym_boxbox_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    rc = fn(out)
    if rc:
        raise RuntimeError(f"boxbox_info: CUDA error {rc} "
                           f"({_lib.robogym_error_string(rc).decode()})")
    return dict(zip(("lanes_per_pair", "pairs_per_block", "threads", "smem_bytes", "registers",
                     "blocks_per_sm"), out))


def launch(name: str, *args) -> None:
    """Launch kernel `name` with tensors (as device pointers; None, but not
    the first, as a null pointer) and ints, on the current stream of the
    first tensor's device."""
    build()
    n_ptr, n_int = SIGNATURES[name]
    tensors, ints = args[:n_ptr], args[n_ptr:]
    if (len(ints) != n_int or not all(isinstance(a, torch.Tensor) for a in tensors[:1])
            or not all(a is None or isinstance(a, torch.Tensor) for a in tensors)
            or not all(isinstance(a, int) for a in ints)):
        raise TypeError(f"{name} takes {n_ptr} tensors (None for a null pointer, not the "
                        f"first) and {n_int} ints")
    device = tensors[0].device
    for a in tensors:
        if a is not None and (a.device != device or not a.is_contiguous()):
            raise ValueError(f"{name}: operand on {a.device} (contiguous: {a.is_contiguous()}), "
                             f"want contiguous tensors on {device}")
    fn = getattr(_lib, "robogym_" + name)
    cargs = [None if a is None else a.data_ptr() for a in tensors] + list(ints)
    with torch.cuda.device(device):
        rc = fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc} "
                           f"({_lib.robogym_error_string(rc).decode()})")
    LAUNCHES[name] += 1
