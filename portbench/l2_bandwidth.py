"""The card's L2 read bandwidth, the roof of ``metrics/gather_roofline.py``.

    python3 -m portbench.l2_bandwidth

A hash-grid SDF's table (48.8 MB) nearly fits the H100's 50 MB L2, so its
gathers are served from L2 and can pass HBM's peak. This measures what L2
serves: a kernel (built here by ``nvcc``, its C entry loaded by ``ctypes``)
reads a buffer of 2^k 8-byte words with ``ld.global.cg`` (L2 only, no L1
reuse), every thread ``REPS`` loads, in two patterns:

  * ``stream``: neighbouring threads read neighbouring words (full 32-byte
    sectors), 8 or 16 bytes a load;
  * ``scatter``: each load a word drawn by a multiplicative hash (a sector a
    load, as incoherent gathers are).

Buffers of 8, 16 and 32 MB stay in L2; 128 MB streams from HBM, for scale.
Each pattern and size runs ``LAUNCHES`` timed launches after one warm-up;
the median's bytes over its time is the rate. Prints one JSON line: the
card, its power limit and the rates in bytes/s; ``l2_bytes_per_s`` is the
largest L2-resident rate. A small launch is checked against the same reads
in PyTorch first.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from cudaneuralrender_torch.kernels import build

from . import work

SOURCE = r"""
#include <cuda_runtime.h>
template <typename T>
__global__ void l2_read(const T* __restrict__ src, T* __restrict__ out, unsigned mask,
                        int reps, int scatter) {
    unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned threads = gridDim.x * blockDim.x;
    T acc = {};
    #pragma unroll 8
    for (int r = 0; r < reps; ++r) {
        unsigned i = tid + (unsigned)r * threads;
        if (scatter) i *= 2654435761u;
        T v = __ldcg(src + (i & mask));
        acc.x ^= v.x;
        acc.y ^= v.y;
    }
    out[tid] = acc;
}
extern "C" int l2_read(const void* src, void* out, unsigned mask, int reps, int scatter,
                       int wide, int blocks, int threads, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (wide)
        l2_read<ulonglong2><<<blocks, threads, 0, s>>>((const ulonglong2*)src,
                                                       (ulonglong2*)out, mask, reps, scatter);
    else
        l2_read<uint2><<<blocks, threads, 0, s>>>((const uint2*)src, (uint2*)out, mask, reps,
                                                  scatter);
    return (int)cudaGetLastError();
}
"""

#: Buffer sizes (bytes): three that stay in L2, one that does not.
L2_SIZES = (8 << 20, 16 << 20, 32 << 20)
HBM_SIZE = 128 << 20
REPS = 1024
THREADS = 256
BLOCKS_PER_SM = 8
LAUNCHES = 20


def _library(tmp: str) -> ctypes.CDLL:
    src = os.path.join(tmp, "l2_read.cu")
    lib = os.path.join(tmp, "l2_read.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    out = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    out.l2_read.argtypes = [p, p, ctypes.c_uint, i, i, i, i, i, p]
    out.l2_read.restype = i
    return out


def _launch(lib, buf, out, reps: int, scatter: bool, wide: bool, blocks: int) -> None:
    word = 16 if wide else 8
    mask = buf.numel() * buf.element_size() // word - 1
    err = lib.l2_read(buf.data_ptr(), out.data_ptr(), mask, reps, int(scatter), int(wide),
                      blocks, THREADS, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"l2_read launch failed: CUDA error {err}")


def _check(lib, dev) -> None:
    """One small launch of each pattern against the same reads in PyTorch."""
    words = torch.randint(-2 ** 62, 2 ** 62, (1 << 12,), dtype=torch.int64, device=dev)
    pairs = words.view(torch.int32).view(-1, 2)
    blocks, reps = 2, 3
    n = blocks * THREADS
    for scatter in (False, True):
        out = torch.empty(n, 2, dtype=torch.int32, device=dev)
        _launch(lib, words, out, reps, scatter, False, blocks)
        i = torch.arange(n, dtype=torch.int64, device=dev)[:, None] + n * torch.arange(
            reps, dtype=torch.int64, device=dev)
        if scatter:
            i = (i * 2654435761) & 0xFFFFFFFF
        got = pairs[i & (pairs.shape[0] - 1)]
        want = got[:, 0]
        for r in range(1, reps):
            want = want ^ got[:, r]
        if not torch.equal(out, want):
            raise RuntimeError(f"l2_read (scatter={scatter}) differs from its PyTorch reads")


def _rate(lib, size: int, scatter: bool, wide: bool, dev) -> float:
    buf = torch.randint(-2 ** 62, 2 ** 62, (size // 8,), dtype=torch.int64, device=dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, 4 if wide else 2, dtype=torch.int32, device=dev)
    _launch(lib, buf, out, REPS, scatter, wide, blocks)  # warm-up: the buffer into L2
    ms = []
    for _ in range(LAUNCHES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _launch(lib, buf, out, REPS, scatter, wide, blocks)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    moved = blocks * THREADS * REPS * (16 if wide else 8)
    return moved / (statistics.median(ms) / 1e3)


def main() -> int:
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        lib = _library(tmp)
        _check(lib, dev)
        rates = {}
        for size in L2_SIZES + (HBM_SIZE,):
            for name, scatter, wide in (("stream8", False, False), ("stream16", False, True),
                                        ("scatter8", True, False)):
                rates[f"{name}_{size >> 20}MB"] = _rate(lib, size, scatter, wide, dev)
    l2 = max(v for k, v in rates.items() if not k.endswith(f"_{HBM_SIZE >> 20}MB"))
    print(json.dumps(dict(card=work.power_limit(), l2_bytes_per_s=l2, bytes_per_s=rates)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
