"""The CUDA sources under graingraphnn_torch/csrc/, compiled for the CPU
with g++ against a small emulation of the CUDA subset they use, against
their plain versions. This checks the kernels' logic (indexing, tiling,
the block-wide scans, the editor's control flow) where there is no GPU;
speed and the GPU compiler's view are checked on the card only
(tests/test_torch_cuda.py, chip_smoke.py).

Emulation: each block runs its threads as std::threads, one after the
other block; __syncthreads is a barrier; a warp shuffle exchanges values
through memory between two barriers. That is exact for these kernels,
whose every thread reaches every barrier and shuffle."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from graingraphnn_torch.kernels import _build, edge_stage, editor_fused
from graingraphnn_torch.ops import period_conv
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import topology_jit as tj

EMU_H = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline std::vector<int64_t>* emu_x = nullptr;
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __shared__ static
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
template <class T> T emu_pull(T v, int src) {
  int64_t b = 0;
  memcpy(&b, &v, sizeof(T));
  (*emu_x)[threadIdx.x] = b;
  __syncthreads();
  int64_t r = (*emu_x)[src];
  __syncthreads();
  T out;
  memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  return emu_pull(v, threadIdx.x ^ o);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return emu_pull(v, lane >= d ? (int)threadIdx.x - d : (int)threadIdx.x);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, dim3 block, A... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::barrier<> bar(block.x);
    std::vector<int64_t> x(block.x);
    emu_bar = &bar;
    emu_x = &x;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""


def _translate(src: str) -> str:
    """`k<<<grid, block, smem, stream>>>(args)` -> `emu_launch(k, grid,
    block, args)`; the CUDA runtime header -> the emulation header."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        name_start = j
        while name_start > 0 and (src[name_start - 1].isalnum()
                                  or src[name_start - 1] == "_"):
            name_start -= 1
        k = src.find(">>>(", j)
        parts, depth, cur = [], 0, ""
        for ch in src[j + 3:k]:
            depth += ch in "(<"
            depth -= ch in ")>"
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        out += [src[i:name_start],
                f"emu_launch({src[name_start:j]}, {parts[0]}, {parts[1]}, "]
        i = k + 4
    return "".join(out) + src[i:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """build(source, symbol, argtypes, defines) -> the C entry of a CPU
    build of csrc/<source>.cu, built once per (source, defines): dlopen
    would hand back the code already loaded from a rebuilt path."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    d = tmp_path_factory.mktemp("csrc_emu")
    (d / "emu.h").write_text(EMU_H)
    built = {}

    def build(source, symbol, argtypes, defines=()):
        key = (source, tuple(defines))
        if key in built:
            return built[key]
        so = d / f"lib{source}{len(built)}.so"
        with open(os.path.join(_build.CSRC, source + ".cu")) as f:
            (d / f"{source}.cpp").write_text(_translate(f.read()))
        subprocess.run(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", f"-I{d}", *[f"-D{x}" for x in defines],
             "-o", str(so), str(d / f"{source}.cpp")],
            check=True, capture_output=True, timeout=600)
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int

        def call(*args):
            assert fn(*args) == 0

        built[key] = call
        return call

    return build


@pytest.mark.parametrize("G,C,K,Ns,Nd,Fs,Fd", [
    (4, 8, 3, 40, 37, 19, 17), (4, 8, 16, 37, 21, 17, 19),
    (1, 16, 3, 30, 33, 11, 8), (4, 96, 16, 29, 5, 107, 104)])
def test_edge_stage_source_matches_plain(emulated, G, C, K, Ns, Nd, Fs, Fd):
    fn = emulated(edge_stage.SOURCE, "edge_stage_forward",
                  edge_stage._ARGTYPES)
    rng = np.random.default_rng(K + Nd)
    conv = period_conv.PeriodConv(Fs, Fd, C, G)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0, 0.3, p.shape).astype(np.float32)))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.7).astype(np.float32)
    mask[::4] = 0.0
    mask = t(mask)
    out = edge_stage.launch(fn, 0, conv, xs, xd, nbr, ln, mask, G, C)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              num_gates=G, out_channels=C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def _editor_cases():
    x, edges, mask, lxd, patch = dd.load_fixture()
    st, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch, device="cpu")
    rng = np.random.default_rng(0)
    NJ = st.xj.shape[0]
    ts = tj.TopoState(
        E_pp=st.E_pp, E_pq=st.E_pq, xj=st.xj,
        y_joint=torch.from_numpy(
            rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)),
        mask_g=st.mask_g, mask_j=st.mask_j, append_ptr=st.n_pp)
    cases = [chip_smoke.forced_editor_inputs(ts, s, n_sw, n_el)
             for s, n_sw, n_el in ((0, 8, 2), (1, 24, 4), (2, 30, 0))]
    return cases + chip_smoke.forced_out_chain(ts)


@pytest.mark.parametrize("threads", [64, 96])
def test_editor_source_matches_plain(emulated, threads):
    """Threads per block are a compile-time constant; 64 and 96 give two
    and three warps and uneven scan chunks (the card uses 512)."""
    fn = emulated(editor_fused.SOURCE, "editor_update",
                  editor_fused._ARGTYPES, (f"EDITOR_THREADS={threads}",))
    cases = _editor_cases()
    n_extra = 0
    for ts, logits, ge, yg in cases:
        prob = torch.sigmoid(logits)
        NG = ts.mask_g.shape[0]
        ref = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG)
        out = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG,
                                  tj.MAX_SWITCH)
        for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr"):
            assert torch.equal(getattr(out[0], f), getattr(ref[0], f)), f
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        for f in ("xj", "y_joint"):
            torch.testing.assert_close(getattr(out[0], f),
                                       getattr(ref[0], f), atol=1e-6, rtol=0)
        n_extra += int((ref[2] >= 0).sum())
    assert n_extra >= 1            # the forced elimination ran
