// The attention core of the attention megablock (K-MEGA, K2, K3:
// csrc/attention_megablock.cu) and of whole-head attention on a fused qkv
// (K6: csrc/attention_block.cu): softmax(q . kᵀ · scale) · v per (batch
// element, head) from the (b·n, 3·heads·64) qkv, and its backward.
//
// Cast order (as the Pallas kernels): scores are fp32 (q . k) * scale; keys
// where the mask is 0, and keys past the query when causal, get -inf. With
// maybe_dead a row with no valid key gets m = 0 and p = 1 on every column
// (uniform weights over the n real keys). l = max(sum p, 1e-30); p / l is
// cast to the storage dtype before p @ v (fp32 accumulation), and the head
// outputs are cast to the storage dtype. Head h takes q from columns
// [h*64, (h+1)*64) of a row, k from hd + h*64 and v from 2*hd + h*64.
//
// bf16 runs on the mma.sync kernels of attention_block_sm90.cuh: K6 in
// their K6 mode, the megablock in their megablock mode (launch_attention
// and launch_mega_attention_bwd below); their notes give the design and
// what bounds it. What follows is the fp32 path, which the tests and the
// fp32 goldens run.
//
// Forward, one block per (32-query tile, head, batch element): the tile's
// full fp32 score rows (32 x n) live in shared memory, so the softmax is
// exact rather than online, by FMAs. The row statistics go out as the
// megablock's (m, l) pair per head (`sm`) or as K6's log-sum-exp m + log l
// (`lse`), or not at all.
//
// Backward: two kernels, each owning its outputs (no atomics): a
// query-tile kernel (32 queries x all keys, as the forward) gives dq and
// the row terms delta; a key-tile kernel (64 keys, walking all queries 32
// at a time) recomputes s and dp for its keys and gives dk and dv. p is
// rebuilt from the forward's statistics (not re-reduced): the megablock's
// p = (dead ? 1 : exp(s - m)) / l, K6's p = exp(s - lse) and 1/n on a dead
// row. The row cotangent do (`dattn`) is the megablock's dattn or K6's do.
// The megablock folds the scale into do (dp = do * scale · vᵀ, delta =
// scale · Σ do · attnout, ds = p (dp - delta)); K6 applies it to ds as
// `_bwd_kernel` does (dp = do · vᵀ, delta = Σ do · out, ds = p (dp - delta)
// scale). Then ds is zeroed on dead rows; dq = ds · k, dk = dsᵀ · q, dv =
// pᵀ · do.
//
// What bounds it on the card: it runs in fp32 only, off the flagship's
// bf16 paths; it re-stages k and v for every 32-query tile, keeps full
// score rows in shared memory (which bounds n) and multiplies on FMAs.
#pragma once

#include "attention_block_sm90.cuh"

namespace {

constexpr int QT = 32;       // queries per forward block
constexpr int KC = 64;       // keys staged per step
constexpr int DH = 64;       // dim_head
constexpr int ALD = DH + 1;  // padded row stride of the staged q/k/v rows
constexpr int QLD = DH + 8;  // row stride of the backward's staged rows
constexpr int OLD = DH + 4;  // row stride of staged output tiles

using xclip::up128;

// The row statistics of query q, head h: the megablock's (m, l) in sm,
// (b*n) x (2*heads) with m at column h and l at heads + h; K6's lse,
// (b*n) x heads.
__device__ __forceinline__ void store_row_stats(float* sm, float* lse, int bi,
                                                int n, int q, int h,
                                                int heads, float m, float l) {
  const long row = (long)bi * n + q;
  if (sm) {
    sm[row * 2 * heads + h] = m;
    sm[row * 2 * heads + heads + h] = l;
  }
  if (lse) lse[row * heads + h] = m + logf(l);
}

inline size_t attention_fma_smem_bytes(int n) {
  return sizeof(float) * ((size_t)QT * n + QT * ALD + KC * ALD);
}

__global__ void __launch_bounds__(xclip::kThreads)
attention_fma_kernel(const float* __restrict__ qkv,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ attnout, int n, int heads,
                     float scale, int causal, int maybe_dead,
                     float* __restrict__ sm, float* __restrict__ lse) {
  using namespace xclip;
  // one dynamic shared-memory array per translation unit: every kernel
  // declares it alike and casts
  extern __shared__ __align__(128) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);  // QT x n scores, then probs
  float* qs = s + QT * n;      // QT x ALD
  float* kv = qs + QT * ALD;   // KC x ALD
  const int q0 = blockIdx.x * QT, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const float* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;

  for (int i = threadIdx.x; i < QT * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * ALD + d] = q0 + r < n ? base[(long)(q0 + r) * ld + h * DH + d] : 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * ALD + d] =
          j0 + r < n ? base[(long)(j0 + r) * ld + hd + h * DH + d] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KC; i += kThreads) {
      const int r = i / KC, c = i % KC, j = j0 + c;
      if (j >= n) continue;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) acc = fmaf(qs[r * ALD + d], kv[c * ALD + d], acc);
      const bool valid = mrow[j] != 0 && !(causal && j > q0 + r);
      s[(long)r * n + j] = valid ? acc * scale : -INFINITY;
    }
  }
  __syncthreads();

  // softmax, one warp per query row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT && q0 + r < n; r += kThreads / 32) {
    float* sr = s + (long)r * n;
    bool dead = false;
    if (maybe_dead) {
      const int lim = causal ? q0 + r + 1 : n;
      int any = 0;
      for (int j = lane; j < lim; j += 32) any |= mrow[j] != 0;
      dead = !__any_sync(0xffffffffu, any);
    }
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
    mx = dead ? 0.f : warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = dead ? 1.f : expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
    const float l = fmaxf(warp_sum(sum), 1e-30f);
    if (lane == 0) store_row_stats(sm, lse, bi, n, q0 + r, h, heads, mx, l);
    for (int j = lane; j < n; j += 32) sr[j] = sr[j] / l;
  }

  // o = p @ v; thread t owns outputs (r, d) = divmod(t + i * kThreads, DH)
  constexpr int OPT = QT * DH / kThreads;
  float acc[OPT] = {};
  for (int j0 = 0; j0 < n; j0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * ALD + d] = j0 + r < n
          ? base[(long)(j0 + r) * ld + 2 * hd + h * DH + d] : 0.f;
    }
    __syncthreads();
    const int jn = min(KC, n - j0);
#pragma unroll
    for (int t = 0; t < OPT; ++t) {
      const int i = threadIdx.x + t * kThreads, r = i / DH, d = i % DH;
      const float* pr = s + (long)r * n + j0;
      float a = acc[t];
      for (int c = 0; c < jn; ++c) a = fmaf(pr[c], kv[c * ALD + d], a);
      acc[t] = a;
    }
  }
#pragma unroll
  for (int t = 0; t < OPT; ++t) {
    const int i = threadIdx.x + t * kThreads, r = i / DH, d = i % DH;
    if (q0 + r < n) attnout[((long)bi * n + q0 + r) * hd + h * DH + d] = acc[t];
  }
}

// attnout (b*n x hd, T) from qkv (b*n x 3hd, T); with `sm` the rows' (m,
// l), with `lse` (fp32 only: bf16 K6 launches its own kernel) their
// log-sum-exp.
template <typename T>
int launch_attention(const T* qkv, const uint8_t* mask, T* attnout, int b,
                     int n, int heads, float scale, int causal, int maybe_dead,
                     float* sm, cudaStream_t st, float* lse = nullptr) {
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    return xclip::launch_k6_fwd<true>(qkv, mask, attnout, sm, b, n, heads,
                                      scale, causal, maybe_dead, st);
  } else {
    const size_t smem = attention_fma_smem_bytes(n);
    cudaError_t e = cudaFuncSetAttribute(
        attention_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_fma_kernel<<<dim3((n + QT - 1) / QT, heads, b), xclip::kThreads,
                           smem, st>>>(qkv, mask, attnout, n, heads, scale,
                                       causal, maybe_dead, sm, lse);
    XCLIP_CHECK_LAUNCH();
    return 0;
  }
}

// ------------------------------------------------------------ backward

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int PLD = BK + 8;   // row stride of the key-tile rows (p, ds)

// Stage rows [r0, r0 + rows) of the 64 columns at `col` (row stride ld) as
// rows of stride QLD; rows at or past n read as 0.
__device__ __forceinline__ void stage_head(float* dst, const float* base,
                                           int ld, int col, int r0, int rows,
                                           int n) {
  for (int i = threadIdx.x; i < rows * DH; i += xclip::kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * QLD + d] = r0 + r < n ? base[(long)(r0 + r) * ld + col + d] : 0.f;
  }
}

// The first valid key of a batch element's mask (n if none): a row q is
// dead when no key up to q (causal) or none at all is valid.
__device__ int first_valid_key(const uint8_t* mrow, int n) {
  __shared__ int fv;
  if (threadIdx.x == 0) fv = n;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += xclip::kThreads)
    if (mrow[j]) {
      atomicMin(&fv, j);  // integer minimum: the same result in any order
      break;
    }
  __syncthreads();
  return fv;
}

// The (m, l) the backward rebuilds p from for query q < n of head h: the
// megablock's stored pair, or (lse, 1) from K6's log-sum-exp, (0, n) on a
// dead row (p = 1 / n, `uniform / n_real`).
template <bool LSE>
__device__ __forceinline__ void load_row_stats(const float* stats, long row,
                                               int h, int heads, int n,
                                               bool dead, float& m, float& l) {
  if (LSE) {
    m = stats[row * heads + h];
    l = dead ? (float)n : 1.f;
  } else {
    m = stats[row * 2 * heads + h];
    l = stats[row * 2 * heads + heads + h];
  }
}

struct DqLayout {
  int n_pad, lds, ldp;
  size_t sp, ds, qs, dos, kv, dpc, dqa, info, bytes;
  __host__ __device__ explicit DqLayout(int n) {
    n_pad = (n + BK - 1) / BK * BK;
    lds = n_pad + 4;
    ldp = n_pad + 8;
    sp = 0;
    ds = up128(sp + sizeof(float) * BQ * lds);
    qs = up128(ds + sizeof(float) * BQ * ldp);
    dos = up128(qs + sizeof(float) * BQ * QLD);
    kv = up128(dos + sizeof(float) * BQ * QLD);
    dpc = up128(kv + sizeof(float) * BK * QLD);
    dqa = up128(dpc + sizeof(float) * BQ * OLD);
    info = up128(dqa + sizeof(float) * BQ * OLD);
    bytes = up128(info + sizeof(float) * 4 * BQ);
  }
};

// dq for one (32-query tile, head, batch element), and delta for its rows.
// `dattn` the row cotangents (b*n x hd); `out` the forward's attention
// output (b*n x hd); `stats` the forward's row statistics.
template <bool LSE>
__global__ void __launch_bounds__(xclip::kThreads)
attention_bwd_dq_kernel(const float* __restrict__ qkv,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ dattn,
                        const float* __restrict__ attnout,
                        const float* __restrict__ stats,
                        float* __restrict__ dqkv, float* __restrict__ delta,
                        int n, int heads, float scale, int causal,
                        int maybe_dead) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const DqLayout L(n);
  float* sp = reinterpret_cast<float*>(smem + L.sp);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* dos = reinterpret_cast<float*>(smem + L.dos);
  float* kv = reinterpret_cast<float*>(smem + L.kv);
  float* dpc = reinterpret_cast<float*>(smem + L.dpc);
  float* dqa = reinterpret_cast<float*>(smem + L.dqa);
  float* rm = reinterpret_cast<float*>(smem + L.info);
  float* rl = rm + BQ;
  float* rdelta = rl + BQ;
  float* rdead = rdelta + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const float* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fv = first_valid_key(mrow, n);
  // the megablock folds the softmax scale into do and delta, K6 into ds
  const float dscale = LSE ? 1.f : scale;

  stage_head(qs, base, ld, h * DH, q0, BQ, n);
  for (int i = threadIdx.x; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    dos[r * QLD + d] =
        q < n ? dattn[((long)bi * n + q) * hd + h * DH + d] * dscale : 0.f;
  }
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int q = q0 + r;
    float dl = 0.f;
    if (q < n)
      for (int d = lane; d < DH; d += 32) {
        const long o = ((long)bi * n + q) * hd + h * DH + d;
        dl += dattn[o] * attnout[o] * dscale;
      }
    dl = warp_sum(dl);
    if (lane == 0) {
      const bool dead = maybe_dead && (causal ? fv > q : fv >= n);
      rm[r] = 0.f;
      rl[r] = 1.f;
      if (q < n)
        load_row_stats<LSE>(stats, (long)bi * n + q, h, heads, n, dead, rm[r],
                            rl[r]);
      rdelta[r] = dl;
      rdead[r] = dead;
      if (q < n) delta[((long)bi * n + q) * heads + h] = dl;
    }
  }
  for (int j0 = 0; j0 < L.n_pad; j0 += BK) {  // s = q · kᵀ, raw fp32
    __syncthreads();
    stage_head(kv, base, ld, hd + h * DH, j0, BK, n);
    __syncthreads();
    xclip::block_mma<BQ, BK, false, true>(sp + j0, L.lds, qs, QLD, kv, QLD, DH,
                                          false);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * L.n_pad; i += kThreads) {
    const int r = i / L.n_pad, j = i % L.n_pad, q = q0 + r;
    float p = 0.f;
    if (q < n && j < n) {
      const bool valid = mrow[j] != 0 && !(causal && j > q);
      const float v = valid ? sp[r * L.lds + j] * scale : -INFINITY;
      p = (rdead[r] != 0.f ? 1.f : expf(v - rm[r])) / rl[r];
    }
    sp[r * L.lds + j] = p;
  }
  for (int j0 = 0; j0 < L.n_pad; j0 += BK) {  // dp, ds
    __syncthreads();
    stage_head(kv, base, ld, 2 * hd + h * DH, j0, BK, n);
    __syncthreads();
    xclip::block_mma<BQ, BK, false, true>(dpc, OLD, dos, QLD, kv, QLD, DH,
                                          false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, j = j0 + c, q = q0 + r;
      float v = 0.f;
      if (q < n && j < n && rdead[r] == 0.f) {
        v = sp[r * L.lds + j] * (dpc[r * OLD + c] - rdelta[r]);
        if (LSE) v *= scale;
      }
      ds[r * L.ldp + j] = v;
    }
  }
  for (int j0 = 0; j0 < L.n_pad; j0 += BK) {  // dq = ds · k
    __syncthreads();
    stage_head(kv, base, ld, hd + h * DH, j0, BK, n);
    __syncthreads();
    xclip::block_mma<BQ, DH, false, false>(dqa, OLD, ds + j0, L.ldp, kv, QLD,
                                           BK, j0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    if (q0 + r < n)
      dqkv[((long)bi * n + q0 + r) * ld + h * DH + d] = dqa[r * OLD + d];
  }
}

struct DkvLayout {
  size_t ks, vs, qs, dos, dov, sc, dpc, pT, dsT, dka, dva, info, bytes;
  __host__ __device__ DkvLayout() {
    ks = 0;
    vs = up128(ks + sizeof(float) * BK * QLD);
    qs = up128(vs + sizeof(float) * BK * QLD);
    dos = up128(qs + sizeof(float) * BQ * QLD);
    dov = up128(dos + sizeof(float) * BQ * QLD);
    sc = up128(dov + sizeof(float) * BQ * QLD);
    dpc = up128(sc + sizeof(float) * BQ * OLD);
    pT = up128(dpc + sizeof(float) * BQ * OLD);
    dsT = up128(pT + sizeof(float) * BQ * PLD);
    dka = up128(dsT + sizeof(float) * BQ * PLD);
    dva = up128(dka + sizeof(float) * BK * OLD);
    info = up128(dva + sizeof(float) * BK * OLD);
    bytes = up128(info + sizeof(float) * 4 * BQ);
  }
};

// dk and dv for one (64-key tile, head, batch element), over every query.
template <bool LSE>
__global__ void __launch_bounds__(xclip::kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ qkv,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dattn,
                         const float* __restrict__ stats,
                         const float* __restrict__ delta,
                         float* __restrict__ dqkv, int n, int heads,
                         float scale, int causal, int maybe_dead) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvLayout L;
  float* ks = reinterpret_cast<float*>(smem + L.ks);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* dos = reinterpret_cast<float*>(smem + L.dos);
  float* dov = reinterpret_cast<float*>(smem + L.dov);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* dpc = reinterpret_cast<float*>(smem + L.dpc);
  float* pT = reinterpret_cast<float*>(smem + L.pT);
  float* dsT = reinterpret_cast<float*>(smem + L.dsT);
  float* dka = reinterpret_cast<float*>(smem + L.dka);
  float* dva = reinterpret_cast<float*>(smem + L.dva);
  float* rm = reinterpret_cast<float*>(smem + L.info);
  float* rl = rm + BQ;
  float* rdelta = rl + BQ;
  float* rdead = rdelta + BQ;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const float* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;
  const int fv = first_valid_key(mrow, n);
  const float dscale = LSE ? 1.f : scale;

  stage_head(ks, base, ld, hd + h * DH, k0, BK, n);
  stage_head(vs, base, ld, 2 * hd + h * DH, k0, BK, n);
  for (int r0 = 0; r0 < n; r0 += BQ) {
    __syncthreads();
    stage_head(qs, base, ld, h * DH, r0, BQ, n);
    for (int i = threadIdx.x; i < BQ * DH; i += kThreads) {
      const int r = i / DH, d = i % DH, q = r0 + r;
      const float a = q < n ? dattn[((long)bi * n + q) * hd + h * DH + d] : 0.f;
      dos[r * QLD + d] = a * dscale;
      dov[r * QLD + d] = a;
    }
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int q = r0 + r;
      const bool dead = maybe_dead && (causal ? fv > q : fv >= n);
      rm[r] = 0.f;
      rl[r] = 1.f;
      if (q < n)
        load_row_stats<LSE>(stats, (long)bi * n + q, h, heads, n, dead, rm[r],
                            rl[r]);
      rdelta[r] = q < n ? delta[((long)bi * n + q) * heads + h] : 0.f;
      rdead[r] = dead;
    }
    __syncthreads();
    xclip::block_mma<BQ, BK, false, true>(sc, OLD, qs, QLD, ks, QLD, DH, false);
    xclip::block_mma<BQ, BK, false, true>(dpc, OLD, dos, QLD, vs, QLD, DH,
                                          false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, q = r0 + r, j = k0 + c;
      float p = 0.f, v = 0.f;
      if (q < n && j < n) {
        const bool valid = mrow[j] != 0 && !(causal && j > q);
        const float s = valid ? sc[r * OLD + c] * scale : -INFINITY;
        p = (rdead[r] != 0.f ? 1.f : expf(s - rm[r])) / rl[r];
        if (rdead[r] == 0.f) {
          v = p * (dpc[r * OLD + c] - rdelta[r]);
          if (LSE) v *= scale;
        }
      }
      pT[r * PLD + c] = p;
      dsT[r * PLD + c] = v;
    }
    __syncthreads();
    xclip::block_mma<BK, DH, true, false>(dka, OLD, dsT, PLD, qs, QLD, BQ,
                                          r0 > 0);
    xclip::block_mma<BK, DH, true, false>(dva, OLD, pT, PLD, dov, QLD, BQ,
                                          r0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BK * DH; i += kThreads) {
    const int c = i / DH, d = i % DH, j = k0 + c;
    if (j < n) {
      const long o = ((long)bi * n + j) * ld + h * DH + d;
      dqkv[o + hd] = dka[c * OLD + d];
      dqkv[o + 2 * hd] = dva[c * OLD + d];
    }
  }
}

// fp32: dqkv (b*n x 3hd) from qkv, the row cotangents dattn (b*n x hd),
// the forward's output attnout (b*n x hd) and row statistics (LSE: K6's
// lse; else the megablock's sm); `delta` is b*n x heads scratch (the dq
// kernel writes it, the dk/dv kernel reads it).
template <bool LSE>
int launch_attention_fma_bwd(const float* qkv, const uint8_t* mask,
                             const float* dattn, const float* attnout,
                             const float* stats, float* dqkv, float* delta,
                             int b, int n, int heads, float scale, int causal,
                             int maybe_dead, cudaStream_t st) {
  const size_t dq_smem = DqLayout(n).bytes;
  const size_t dkv_smem = DkvLayout().bytes;
  cudaError_t ce = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(attention_bwd_dkv_kernel<LSE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dkv_smem);
  if (ce != cudaSuccess) return (int)ce;
  attention_bwd_dq_kernel<LSE>
      <<<dim3((n + BQ - 1) / BQ, heads, b), xclip::kThreads, dq_smem, st>>>(
          qkv, mask, dattn, attnout, stats, dqkv, delta, n, heads, scale,
          causal, maybe_dead);
  XCLIP_CHECK_LAUNCH();
  attention_bwd_dkv_kernel<LSE>
      <<<dim3((n + BK - 1) / BK, heads, b), xclip::kThreads, dkv_smem, st>>>(
          qkv, mask, dattn, stats, delta, dqkv, n, heads, scale, causal,
          maybe_dead);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// The megablock's attention backward: dqkv (b*n x 3hd, T) from qkv, its
// fp32 row cotangents dattn (b*n x hd), attnout and sm; delta (b*n x
// heads) fp32 scratch. bf16 runs the megablock mode of
// attention_block_sm90.cuh, whose dq kernel rewrites dattn in place as its
// two bf16 copies (the caller's scratch, read by nothing after this
// launch); fp32 the FMA kernels above.
template <typename T>
int launch_mega_attention_bwd(const T* qkv, const uint8_t* mask, float* dattn,
                              const T* attnout, const float* sm, T* dqkv,
                              float* delta, int b, int n, int heads,
                              float scale, int causal, int maybe_dead,
                              cudaStream_t st) {
  if constexpr (std::is_same<T, xclip::bf16>::value)
    return xclip::launch_k6_bwd<true>(
        qkv, mask, attnout, sm, dattn, reinterpret_cast<xclip::bf16*>(dattn),
        dqkv, delta, b, n, heads, scale, causal, maybe_dead, st);
  else
    return launch_attention_fma_bwd<false>(qkv, mask, dattn, attnout, sm,
                                           dqkv, delta, b, n, heads, scale,
                                           causal, maybe_dead, st);
}

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

// Largest sequence length the forward takes in dtype code `dtype`: bf16
// the mma.sync kernels' 64 * K6_MAX_TILES; fp32 as long as the forward
// tile's score rows fit one block's shared memory.
inline int attention_max_n(int dtype) {
  if (dtype != xclip::kF32) return xclip::K6_MAX_N;
  return (int)((kMaxSmem - attention_fma_smem_bytes(0)) /
               (sizeof(float) * QT));
}

// Largest sequence length the backward takes in `dtype` (in fp32 its
// query-tile kernel keeps 32 full score rows in shared memory).
inline int attention_bwd_max_n(int dtype) {
  if (dtype != xclip::kF32) return xclip::K6_MAX_N;
  if (DkvLayout().bytes > kMaxSmem) return 0;
  int n = BK;
  while (DqLayout(n + BK).bytes <= kMaxSmem) n += BK;
  return n;
}

}  // namespace
