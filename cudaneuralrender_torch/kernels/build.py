"""Build and load the package's CUDA kernels.

The sources under ``cudaneuralrender_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers). Each ``.cu`` file is one translation unit
(one per hidden width and chain, FP32 and three-pass, the FP32 chain's
ray-split mode at width 128, the C entry points of the render kernels, the
elementwise backward kernels, the shading normals' value-and-gradient kernel,
the hash-grid encoding kernel and its march instantiations, and the
step-cost experiment kernels X1-X3 with their entries); they compile in
parallel processes, one ``nvcc`` each, and link into the library. The build
runs at first CUDA use, never at import, into ``cudaneuralrender_torch/build/``
(listed in .gitignore) under a name keyed by a hash of the sources, headers
and flags, so a second run reuses it. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
#: What the last build printed (ptxas registers / shared memory / spills
#: of every kernel); empty when the library came from an earlier build.
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))
                      + glob.glob(os.path.join(CSRC_DIR, "*.h"))):
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcnr_kernels_{digest.hexdigest()[:16]}.so")


def _nvcc_all(jobs, log_dir: str) -> str:
    """Run every (name, nvcc arguments) job at once, one process each, and
    return their output in job order. Raises, once all have ended, if any
    failed; kills the ones still running if waiting fails."""
    nvcc = _nvcc()
    procs = []
    try:
        for name, args in jobs:
            log = open(os.path.join(log_dir, name + ".log"), "w+")
            procs.append((name, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *args], stdout=log, stderr=subprocess.STDOUT)))
        for _, _, proc in procs:
            proc.wait(timeout=900)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs, failed = [], []
    for name, log, proc in procs:
        log.seek(0)
        outs.append(log.read())
        log.close()
        if proc.returncode != 0:
            failed.append(f"nvcc {name} failed (exit {proc.returncode}):\n{outs[-1]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def _build(out: str) -> None:
    global BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [os.path.join(tmp_dir, os.path.basename(src) + ".o") for src in _sources()]
        log = _nvcc_all([(os.path.basename(src), ["-c", "-o", obj, src])
                         for src, obj in zip(_sources(), objs)], tmp_dir)
        lib = os.path.join(tmp_dir, "lib.so")
        log += _nvcc_all([("link", ["-shared", "-o", lib, *objs])], tmp_dir)
        os.replace(lib, out)  # atomic: a concurrent build never sees a partial file
    BUILD_LOG = log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.cnr_march.argtypes = [
            _I,                      # device
            _P, _P, _P, _P, _P, _P,  # dirs, origin, t0, budget0, active0, steps0
            _P, _P,                  # weights (FP32, or bf16 fragment-ordered), biases
            _I, _I, _I, _P,          # n_layers, hidden, n_inputs, frame ([1] float32)
            _P, _P,                  # hash-grid table, level words (NULL: a dense chain)
            _I, _I, _I, _I,          # scene id, cylinder window, three_pass, ray_lanes
            _I, _I, _I, _F, _F,      # n, max_steps, num_steps, eps, omega
            _P, _P, _P, _P, _P,      # t, budget, active, conv, steps (outputs)
            _P,                      # work: the 128-wide ray-split mode's ray counter, or NULL
            _P,                      # stream
        ]
        lib.cnr_march.restype = _I
        lib.cnr_march_raygen.argtypes = [
            _I,                      # device
            _P, _P,                  # pos, cam_to_world
            _I, _I, _F,              # width, height, focal
            _F, _F, _F, _F,          # bounding sphere center x, y, z, radius squared
            _P, _P,                  # weights (FP32, or bf16 fragment-ordered), biases
            _I, _I, _I, _P,          # n_layers, hidden, n_inputs, frame ([1] float32)
            _P, _P,                  # hash-grid table, level words (NULL: a dense chain)
            _I, _I, _I,              # scene id, cylinder window, three_pass
            _I, _I, _F, _F,          # n, max_steps, eps, omega
            _P, _P, _P, _P, _P,      # t, budget, active, conv, steps (outputs)
            _P,                      # stream
        ]
        lib.cnr_march_raygen.restype = _I
        lib.cnr_mlp_forward.argtypes = [
            _I,                      # device
            _P, _P, _P, _P,          # x, weights, tf32 fragment-ordered weights, biases
            _I, _I, _I, _I,          # n_layers, hidden, n_inputs, n
            _P, _P,                  # out, stream
        ]
        lib.cnr_mlp_forward.restype = _I
        lib.cnr_smem_bytes.argtypes = [_I, _I, _I]  # kind, hidden, n_layers
        lib.cnr_smem_bytes.restype = ctypes.c_longlong
        lib.cnr_x1_loop.argtypes = [
            _I,                      # device
            _P, _P, _P,              # x, w (tf32 fragment order), b
            _I, _I, _I,              # hidden, lanes, reps
            _P, _P,                  # out, stream
        ]
        lib.cnr_x1_loop.restype = _I
        lib.cnr_x2_stepcost.argtypes = [
            _I,                      # device
            _P, _P, _P,              # dirs, t0, origin
            _P, _P,                  # weights (tf32 or bf16 fragment order), biases
            _I, _I, _I, _I, _I,      # n_layers, hidden, variant, three_pass, bf16_input
            _I, _I,                  # n, steps
            _P, _P,                  # t_out, stream
        ]
        lib.cnr_x2_stepcost.restype = _I
        lib.cnr_x3_ablation.argtypes = [
            _I,                      # device
            _P, _P, _P,              # dirs, t0, origin
            _P, _P, _P, _P, _P,      # weights (tf32 fragment order) or NULL, bf16 hi, mid, lo
                                     # (fragment order) or NULL, biases
            _I, _I, _I, _I, _I,      # n_layers, hidden, variant, n, steps
            _P, _P,                  # out, stream
        ]
        lib.cnr_x3_ablation.restype = _I
        lib.cnr_relu_tie_backward.argtypes = [
            _I,                      # device
            _P, _P, _P,              # g, h, out
            ctypes.c_longlong,       # n
            _P,                      # stream
        ]
        lib.cnr_relu_tie_backward.restype = _I
        lib.cnr_mlp_value_grad.argtypes = [
            _I,                      # device
            _P, _P,                  # pts, frame ([1] float32, 4-input nets) or NULL
            _P, _P, _P,              # stack and its transpose (tf32 fragment order), biases
            _I, _I, _I, _I,          # n_layers, hidden, n_inputs, n
            _P, _P, _P,              # value, grad (outputs), stream
        ]
        lib.cnr_mlp_value_grad.restype = _I
        lib.cnr_hash_encode.argtypes = [
            _I,                      # device
            _P, _P, _P,              # points, table, level words
            _P, _I,                  # the features' gradient (NULL: the forward), n
            _P, _P,                  # features or the points' gradient (output), stream
        ]
        lib.cnr_hash_encode.restype = _I
        lib.cnr_value_grad_smem_bytes.argtypes = [_I, _I]  # hidden, n_layers
        lib.cnr_value_grad_smem_bytes.restype = ctypes.c_longlong
        lib.cnr_trace_mark.argtypes = [_I, _P, _I, _I, _P]  # device, buffer, slot, end, stream
        lib.cnr_trace_mark.restype = _I
        lib.cnr_error_string.argtypes = [_I]
        lib.cnr_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib
