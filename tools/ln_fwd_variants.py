#!/usr/bin/env python3
"""The LayerNorm forward rows and K5's backward as shipped and against
their alternatives, on one NVIDIA card.

    python3 tools/ln_fwd_variants.py [variant ...]

(every variant when none is named; see EDITS).

`csrc/row_kernels.cuh` fixes the LayerNorm forward's block (kFwdRows rows,
kFwdThreads threads) and the least number of 8-column vectors a thread
holds of a row outside the GEGLU mode (kFwdMinVectors, 2 as shipped: a
warp a row at width 512; 1 lets a row spread over as many threads as the
block has; 4 keeps the most bytes in flight a thread); its launch bounds
name no least number of blocks an SM (the variants ask for 1, which
lets the compiler take more registers, or 3 or 4, which cap a thread at
80 or 64 for more warps in flight).
`csrc/fused_infonce.cu` fixes the depth of the backward products'
k-slices (GBK) and stages their operands through registers into a
double-buffered shared ring; the k5-cp-async variant copies the operands
whose rows already run along the shared layout by cp.async instead
(K5_ASYNC), and the k5-one-kernel variant computes each 128 x 128 score
tile once for both gradients in one kernel, writing a dx partial per
column tile and a dy partial per row tile (K5_ONE_KERNEL). Each variant is
an edited copy of `csrc/` under `build/`, of which only `rows.cu` and
`fused_infonce.cu` are built (one nvcc each, every variant at once) into a
small library that `kernels/rows.py` and `kernels/fused_infonce.py` then
call. Each variant is checked against the plain versions (chip_smoke.py's
phase 20 and phase 9 tolerances) at chip_smoke.py's LN_FWD_KERNELS shapes
plus 37 ragged rows and at (300, 200, 64), (37, 301, 98) and (2048, 2048,
512) DCL, then
timed (CUDA events) in three turns, the second in reverse order. Needs a
card and nvcc; prints the card and its power limit first, and each
variant's registers a thread (`nvcc -Xptxas -v`).
"""

import ctypes
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from xclip_tpu_torch.kernels import _build  # noqa: E402
from xclip_tpu_torch.kernels import fused_infonce as k5  # noqa: E402
from xclip_tpu_torch.kernels import rows as rk  # noqa: E402

ROWS = "row_kernels.cuh"
K5 = "fused_infonce.cu"
THREADS = "constexpr int kFwdThreads = {};"
VECTORS = "constexpr int kFwdMinVectors = {};"
BLOCK_ROWS = "constexpr int kFwdRows = {};"
BOUNDS = "__launch_bounds__(NT{})\nln_fwd_rows_kernel("
SLICE = "constexpr int GBK = {};"
# K5's products with the operands whose rows already run along the shared
# layout (P^T and dlse x for dy, y for dx) staged by cp.async straight into
# the next shared buffer, one group a slice, instead of through registers;
# the transposed operands (x and y for the scores, P for dx) cannot be
# copied so and keep the register path. dy's dlse scale is applied by the
# thread that issued the copy once it has landed (the same multiply).
K5_LOAD = """      if constexpr (MODE == kDy) {  // A = P^T: P[kk, i], i consecutive
        const int kk = kp + (t >> 5), i = m0 + (t & 31) * 4;
        load4(ra[p], P + (long)kk * cc + i, kk < ke ? M - i : 0, vec_a);
      } else {"""
K5_LOAD_ASYNC = """      if constexpr (MODE == kDy) {  // A = P^T: P[kk, i], i consecutive
        const int kk = kp + (t >> 5), i = m0 + (t & 31) * 4;
        k5_copy4(&As[((k0 - kb) / GBK) & 1][8 * p + (t >> 5)][(t & 31) * 4],
                 P + (long)kk * cc + i, kk < ke ? M - i : 0, vec_a);
      } else {"""
K5_LOAD_B = """        load4(rb[p], (MODE == kDx ? y : x) + (kok ? row * d : 0) + j,
              kok ? N - j : 0, vec_b);
        if (MODE == kDy && kok) {
          const float sc = dlse[kk];
#pragma unroll
          for (int q = 0; q < 4; ++q) rb[p][q] *= sc;
        }"""
K5_LOAD_B_ASYNC = """        k5_copy4(&Bs[((k0 - kb) / GBK) & 1][8 * p + (t >> 5)][(t & 31) * 4],
                 (MODE == kDx ? y : x) + (kok ? row * d : 0) + j,
                 kok ? N - j : 0, vec_b);"""
K5_STORE_A = """      if constexpr (MODE == kDy) {
        *reinterpret_cast<float4*>(&As[buf][8 * p + (t >> 5)][(t & 31) * 4]) =
            make_float4(ra[p][0], ra[p][1], ra[p][2], ra[p][3]);
      } else {"""
K5_STORE_A_ASYNC = """      if constexpr (MODE == kDy) {
      } else {"""
K5_STORE_B = """      } else {
        *reinterpret_cast<float4*>(&Bs[buf][8 * p + (t >> 5)][(t & 31) * 4]) =
            make_float4(rb[p][0], rb[p][1], rb[p][2], rb[p][3]);
      }"""
K5_STORE_B_ASYNC = """      }"""
K5_LANDED = """  auto store = [&](int buf) {"""
K5_LANDED_ASYNC = """  // the copies of the slice into buf have landed; dy's B scaled by dlse
  auto landed = [&](int buf, int k0) {
    xclip::cp_async_commit();
    xclip::cp_async_wait<0>();
    if constexpr (MODE == kDy) {
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        const int kk = k0 + 8 * p + (t >> 5);
        if (kk < ke) {
          const float sc = dlse[kk];
          float* b = &Bs[buf][8 * p + (t >> 5)][(t & 31) * 4];
#pragma unroll
          for (int q = 0; q < 4; ++q) b[q] *= sc;
        }
      }
    }
  };
  auto store = [&](int buf) {"""
K5_FIRST = """    load(kb);
    store(0);
  }"""
K5_FIRST_ASYNC = """    load(kb);
    store(0);
    landed(0, kb);
  }"""
K5_NEXT = """    if (s + 1 < slices) store((s + 1) & 1);
    __syncthreads();"""
K5_NEXT_ASYNC = """    if (s + 1 < slices) {
      store((s + 1) & 1);
      landed((s + 1) & 1, kb + (s + 1) * GBK);
    }
    __syncthreads();"""
K5_HELPER = """template <int MODE>
__global__ void __launch_bounds__(GT, 2)
k5_gemm_kernel("""
K5_HELPER_ASYNC = """// dst[q] = src[q] for q < n (n clamped to 0..4), 0 after, by cp.async:
// one 16-byte copy when all four are in range and vec, else four 4-byte
// copies that zero-fill past n
__device__ __forceinline__ void k5_copy4(float* dst, const float* src, int n,
                                         bool vec) {
  if (vec && n >= 4) {
    xclip::cp_async16(dst, src, true);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + q);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(s),
                 "l"(q < n ? src + q : src), "r"(q < n ? 4 : 0));
  }
}

template <int MODE>
__global__ void __launch_bounds__(GT, 2)
k5_gemm_kernel("""
# K5's backward as one kernel a (128-row, 128-column) score tile: s over
# d (as the shipped scores product), p kept in shared memory in both
# orientations, then from it dx's partial for the column tile and dy's for
# the row tile, d in 128-wide chunks; each partial summed in order by
# k5_sum_kernel. No scores scratch, but (C + R) / 128 partials of R x d and
# C x d in place of the shipped four (allocated stream-ordered).
K5_ENTRY = """extern "C" int xclip_lse_bwd(const void* x, const void* y, const void* lse,"""
K5_FUSED = K5_ENTRY.replace("xclip_lse_bwd(", "xclip_lse_bwd_shipped(")
K5_FUSED_KERNEL = """namespace {
constexpr int FLD = 132;  // row stride of the shared p tiles and slices

// acc (8 x 8 a thread, the layout of k5_gemm_kernel) += A . B over K rows
// of k: A[k][m] at a[k * FLD + m] in shared memory, B[k][n] staged from
// b_row(k) + n0 (columns consecutive, nb columns valid) in 8-deep slices
template <typename BRow>
__device__ __forceinline__ void k5f_ab(float (&acc)[8][8], const float* a,
                                       int K, BRow b_row, int nb,
                                       float* bs, bool vec) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int k0 = 0; k0 < K; k0 += 8) {
    {
      const int kk = k0 + (t >> 5), j = (t & 31) * 4;
      float r[4];
      const float* src = kk < K ? b_row(kk) : nullptr;
      load4(r, src ? src + j : a, src ? nb - j : 0, vec);
      *reinterpret_cast<float4*>(&bs[(t >> 5) * FLD + j]) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* ak = a + (k0 + k) * FLD;
      const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k * FLD + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[k * FLD + 64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int k5f_row(int i, int ty) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

__global__ void __launch_bounds__(256, 1)
k5_fused_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ lse, const float* __restrict__ dlse,
                float* __restrict__ pdx, float* __restrict__ pdy, int R,
                int C, int d, int off, int decoupled, bool vec) {
  extern __shared__ __align__(16) float fsm[];
  float* pt = fsm;              // p[i][j] at pt[j * FLD + i]
  float* pn = pt + 128 * FLD;   // dlse[i] p[i][j] at pn[i * FLD + j]
  float* as = pn + 128 * FLD;   // [8][FLD] x slices
  float* bs = as + 8 * FLD;     // [8][FLD] y slices, then B slices
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * 128;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // s = x[m0 + i] . y[n0 + j] over d, both staged k-major
  for (int k0 = 0; k0 < d; k0 += 8) {
    {
      const int i = t >> 1, kk = k0 + (t & 1) * 4;
      float a4[4], b4[4];
      load4(a4, x + (long)(m0 + i) * d + kk, m0 + i < R ? d - kk : 0, vec);
      load4(b4, y + (long)(n0 + i) * d + kk, n0 + i < C ? d - kk : 0, vec);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        as[((t & 1) * 4 + q) * FLD + i] = a4[q];
        bs[((t & 1) * 4 + q) * FLD + i] = b4[q];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k * FLD + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[k * FLD + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k * FLD + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[k * FLD + 64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int li = k5f_row(i, ty), r = m0 + li;
    const float l = r < R ? lse[r] : 0.f, g = r < R ? dlse[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lj = k5f_row(j, tx), c = n0 + lj;
      const bool ok = r < R && c < C && !(decoupled && c == r + off);
      const float pv = ok ? expf(acc[i][j] - l) : 0.f;
      pt[lj * FLD + li] = pv;
      pn[li * FLD + lj] = pv * g;
    }
  }
  __syncthreads();
  const long ndx = (long)R * d, ndy = (long)C * d;
  for (int c0 = 0; c0 < d; c0 += 128) {
    const int nb = d - c0;
    // dx partial of the column tile: rows m0.., columns c0.. of p . y
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    k5f_ab(acc, pt, min(128, C - n0),
           [&](int k) { return y + (long)(n0 + k) * d + c0; }, nb, bs, vec);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + k5f_row(i, ty);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + k5f_row(j, tx);
        if (r < R && c < d)
          pdx[blockIdx.y * ndx + (long)r * d + c] = acc[i][j];
      }
    }
    // dy partial of the row tile: columns n0.. of p^T . (dlse x)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    k5f_ab(acc, pn, min(128, R - m0),
           [&](int k) { return x + (long)(m0 + k) * d + c0; }, nb, bs, vec);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = n0 + k5f_row(i, ty);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = c0 + k5f_row(j, tx);
        if (c < C && e < d)
          pdy[blockIdx.x * ndy + (long)c * d + e] = acc[i][j];
      }
    }
  }
}
}  // namespace

extern "C" int xclip_lse_bwd(const void* x, const void* y, const void* lse,
                             const void* dlse, void* dx, void* dy, void* p,
                             void* part, int R, int C, int d, int cc, int kx,
                             int ky, int row_offset, int decoupled,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int tr = (R + 127) / 128, tc = (C + 127) / 128;
  float* pdx;
  const size_t ndx = (size_t)R * d, ndy = (size_t)C * d;
  cudaError_t e = cudaMallocAsync(
      (void**)&pdx, sizeof(float) * (tc * ndx + tr * ndy), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * (2 * 128 + 16) * FLD;
  e = cudaFuncSetAttribute(k5_fused_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  k5_fused_kernel<<<dim3(tr, tc), 256, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(lse), static_cast<const float*>(dlse), pdx,
      pdx + tc * ndx, R, C, d, row_offset, decoupled, d % 4 == 0);
  XCLIP_CHECK_LAUNCH();
  int r;
  if ((r = launch_k5_sum(pdx, tc, (long)ndx, d, static_cast<float*>(dx),
                         static_cast<const float*>(dlse), 0, st)))
    return r;
  if ((r = launch_k5_sum(pdx + tc * ndx, tr, (long)ndy, d,
                         static_cast<float*>(dy), nullptr, 0, st)))
    return r;
  return (int)cudaFreeAsync(pdx, st);
}

"""
K5_ONE_KERNEL = [(K5, K5_ENTRY, K5_FUSED_KERNEL + K5_FUSED)]


def in_tile_loop(text):
    """`text` as it stands in k5_gemm_kernel's loop over its column tiles:
    two more spaces a line, directives and blank lines as they are."""
    return textwrap.indent(text, "  ",
                           lambda line: line.strip()
                           and not line.startswith("#"))


K5_ASYNC = [(K5, K5_HELPER, K5_HELPER_ASYNC)] + [
    (K5, in_tile_loop(old), in_tile_loop(new)) for old, new in (
        (K5_LOAD, K5_LOAD_ASYNC), (K5_LOAD_B, K5_LOAD_B_ASYNC),
        (K5_STORE_A, K5_STORE_A_ASYNC), (K5_STORE_B, K5_STORE_B_ASYNC),
        (K5_LANDED, K5_LANDED_ASYNC), (K5_FIRST, K5_FIRST_ASYNC),
        (K5_NEXT, K5_NEXT_ASYNC))]

# (variant, [(file, shipped text, its replacement)])
EDITS = {
    "shipped": [],
    "1-vector": [(ROWS, VECTORS.format(2), VECTORS.format(1))],
    "4-vectors": [(ROWS, VECTORS.format(2), VECTORS.format(4))],
    "512-threads": [(ROWS, THREADS.format(256), THREADS.format(512))],
    "64-rows": [(ROWS, BLOCK_ROWS.format(32), BLOCK_ROWS.format(64))],
    "3-blocks": [(ROWS, BOUNDS.format(""), BOUNDS.format(", 3"))],
    "4-blocks": [(ROWS, BOUNDS.format(""), BOUNDS.format(", 4"))],
    "1-block": [(ROWS, BOUNDS.format(""), BOUNDS.format(", 1"))],
    "k5-slice-16": [(K5, SLICE.format(8), SLICE.format(16))],
    "k5-cp-async": K5_ASYNC,
    "k5-one-kernel": K5_ONE_KERNEL,
}
SOURCES = ("rows.cu", "fused_infonce.cu")
ENTRIES = ("xclip_ln_fwd_rows", "xclip_lse_bwd", "xclip_rows_launches")


def variant_csrc(name):
    """The variant's copy of csrc/, edited."""
    csrc = _build.BUILD_DIR / "fwd_variants" / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    for file, old, new in EDITS[name]:
        f = csrc / file
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: expected one {old!r} in {file}")
        f.write_text(text.replace(old, new))
    return csrc


def build_all(names):
    """{variant: (library, {kernel: registers})}: each variant's two
    sources compiled at once (ptxas -v), then linked."""
    procs = {}
    for name in names:
        csrc = variant_csrc(name)
        for src in SOURCES:
            obj = csrc.parent / f"{Path(src).stem}.o"
            procs[(name, src)] = (obj, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", str(obj), str(csrc / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    regs = {name: {} for name in names}
    for (name, src), (obj, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{out}")
        kernel = None
        for line in out.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                kernel = re.search(r"(ln_fwd_rows_kernel|k5_gemm_kernel)"
                                   r"I(.*?)E", m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                regs[name][f"{kernel.group(1)} {kernel.group(2)}"] = int(
                    m.group(1))
                kernel = None
    libs = {}
    for name in names:
        base = _build.BUILD_DIR / "fwd_variants" / name
        lib = base / "lib.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(lib), *(str(base / f"{Path(s).stem}.o")
                                    for s in SOURCES)], check=True)
        cdll = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            fn = getattr(cdll, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = _build._RESTYPES.get(entry, ctypes.c_int)
        libs[name] = cdll
    return {name: (libs[name], regs[name]) for name in names}


def use(lib):
    _build.library = lambda: lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ln_fwd_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(EDITS)
    unknown = set(names) - set(EDITS)
    if unknown:
        raise SystemExit(f"ln_fwd_variants: no variant {sorted(unknown)}")
    order = [*names, *reversed(names), *names]
    built = build_all(names)
    for name, (_, regs) in built.items():
        print(f"registers {name}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(regs.items())), flush=True)
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(20)
    checks, timed = [], []
    for key, _, mode, _, shapes in cs.LN_FWD_KERNELS:
        for src, rows, d in shapes:
            for extra, into in ((37, checks), (0, timed)):
                args = cs.ln_fwd_inputs(gen, mode, src, rows + extra, d, dt)
                into.append((f"{key} ({rows + extra} x {d}, {src} in)", "ln",
                             args))
    for R, C, d in ((300, 200, 64), (37, 301, 98), (2048, 2048, 512)):
        x = torch.nn.functional.normalize(cs.rand(gen, R, d), dim=-1) * 14.0
        y = torch.nn.functional.normalize(cs.rand(gen, C, d), dim=-1)
        args = (x, y, k5.streaming_lse_fwd_plain(x, y, 0, True),
                cs.rand(gen, R), 0, True)
        checks.append((f"K5 backward ({R}, {C}, {d}) DCL", "k5", args))
        if R == 2048:
            timed.append((f"K5 backward ({R}, {C}, {d}) DCL", "k5", args))

    def run(kind, args, plain=False):
        if kind == "ln":
            return (rk.ln_rows_plain if plain else rk.ln_rows)(*args)
        return (k5.streaming_lse_bwd_plain if plain
                else k5.streaming_lse_bwd)(*args)

    for name, (lib, _) in built.items():
        use(lib)
        for tag, kind, args in checks:
            got, want = run(kind, args), run(kind, args, plain=True)
            if kind == "ln":
                cs.compare_products(f"{name} {tag}", got, want,
                                    cs.LN_FWD_OUTPUTS[args[0]])
            else:
                for n, g, w in zip(("dx", "dy"), got, want):
                    cs.compare(f"{name} {tag} {n}", g, w,
                               1e-5 * float(w.abs().max()))
            del got, want
        torch.cuda.empty_cache()
    times = {}
    for turn, name in enumerate(order):
        use(built[name][0])
        for tag, kind, args in timed:
            ms = cs.cuda_ms(lambda: run(kind, args), reps=7, iters=5)
            times.setdefault((name, tag), []).append(ms)
            print(f"turn {turn} {name:12s} {tag}: {ms:.4f} ms", flush=True)
    for (name, tag), ts in times.items():
        print(f"mean {name:12s} {tag}: {sum(ts) / len(ts):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
