// Flash attention, forward and backward, for Hopper (bf16 in, fp32 softmax).
//
// Replaces: vlaser_tpu/kernels/flash_attention.py :: flash_attention_fwd
// (_flash_fwd_kernel, pallas_call at :206) and flash_attention_bwd
// (_flash_bwd_dq_kernel at :449 and _flash_bwd_dkv_kernel at :488).
//
// What it computes: q [B, Sq, H, D], k/v [B, Skv, KVH, D] (GQA: head h reads
// kv head h / (H / KVH)); a key is allowed iff q_seg == k_seg, k_seg != 0 and
// k_lev <= q_lev (per-token metadata packed as seg << 2 | lev), and, when
// causal, q_offset + q_idx >= k_idx. Softmax statistics are fp32. A row with
// no allowed key gives out = 0 and lse = -1e30 + log(1). The backward
// recomputes P from lse; delta = rowsum(dO * O) comes in from the wrapper.
//
// What bounds it on the H100: at the training shapes (ViT: B=32, S=1025,
// 16 heads x 64; joint: B=32, S=389, 12 q / 2 kv heads x 128) the work is
// 4*B*H*Sq*Skv*D flop forward (0.138 / 0.030 TFLOP) against 0.27 / 0.09 GB
// of q/k/v/o, ~500 flop per byte, so the tensor cores bound it (989 TFLOP/s
// bf16 dense).
//
// What the design does about it: every product runs on the bf16 tensor cores
// (mma.sync m16n8k16, fp32 accumulation). A block of 4 warps owns 64 query
// rows (16 per warp) and walks 64-key tiles held in shared memory, so each
// K/V tile is read once per 64 queries; P never leaves registers (the
// accumulator fragment of S is re-packed as the A operand of P.V). The
// backward keeps the TPU kernels' split so that no float atomics are needed:
// one kernel gives dq (a block per 64 q rows, looping over k tiles), one gives
// dk and dv (a block per (b, kv head, 64 keys), looping over the group's q
// heads and q tiles), which also sums GQA's group in registers. Masks and the
// -1e30 sentinel stay fp32 (-1e30 overflows half precision), masked entries
// are selected to 0 rather than multiplied (exp(s - lse) of a fully masked
// row is inf, and inf * 0 is NaN), and the ragged tile edges (S = 1025, 389)
// read zeros with metadata 0, which the segment rule masks. Simple first:
// tiles load synchronously (no cp.async / TMA) and there is no wgmma.
#include "common.cuh"

namespace fa {

constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BKV = 64;       // keys per tile (fwd, dq) / per block (dkv)
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4).
// A (16 x 16, row major) from s[row][k]: rows r0.., columns k0..
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int ld,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + k0 + 8 + 2 * t);
  a[3] = ld32(s + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}
// B (16 x 8) with B[k][n] = s[n][k]: the operand is stored n-major (K for
// Q.K^T, Q for K.Q^T, ...), so each register is one 32-bit load.
__device__ __forceinline__ void frag_b_nk(uint32_t b[2], const bf16* s, int ld,
                                          int n0, int k0, int g, int t) {
  b[0] = ld32(s + (n0 + g) * ld + k0 + 2 * t);
  b[1] = ld32(s + (n0 + g) * ld + k0 + 8 + 2 * t);
}
// B (16 x 8) with B[k][n] = s[k][n]: stored k-major (V for P.V, ...).
__device__ __forceinline__ void frag_b_kn(uint32_t b[2], const bf16* s, int ld,
                                          int k0, int n0, int g, int t) {
  b[0] = pack_bf(s[(k0 + 2 * t) * ld + n0 + g], s[(k0 + 2 * t + 1) * ld + n0 + g]);
  b[1] = pack_bf(s[(k0 + 8 + 2 * t) * ld + n0 + g],
                 s[(k0 + 9 + 2 * t) * ld + n0 + g]);
}
// The C fragments of two neighbouring n-tiles (16 x 16 of P or dS) as the
// A operand of the next product.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_f(c0[0], c0[1]);
  a[1] = pack_f(c0[2], c0[3]);
  a[2] = pack_f(c1[0], c1[1]);
  a[3] = pack_f(c1[2], c1[3]);
}

// rows [s0, s0 + nrows) of head h of x [B, S, heads, D] -> dst [nrows][LD];
// rows past S read zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ x,
                                          int b, int s0, int nrows, int S,
                                          int heads, int h) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < nrows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, s = s0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * S + s) * heads + h) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

__device__ __forceinline__ bool allowed(int qm, int km) {
  const int qs = qm >> 2, ks = km >> 2;
  return qs == ks && ks != 0 && (km & 3) <= (qm & 3);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
struct FwdSmem {
  static constexpr int LD = D + 8;
  static constexpr int BYTES = (BQ + 2 * BKV) * LD * 2 + (BQ + BKV) * 4;
};

// grid (ceil(Sq / 64), H, B)
template <int D>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ qmeta,
               const int* __restrict__ kmeta, bf16* __restrict__ out,
               float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
               int causal, int q_offset, float scale) {
  constexpr int LD = D + 8, NT = BKV / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BKV * LD;
  int* qms = reinterpret_cast<int*>(Vs + BKV * LD);
  int* kms = qms + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  load_rows<D>(Qs, q, b, q0, BQ, Sq, H, h);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    qms[i] = q0 + i < Sq ? qmeta[(size_t)b * Sq + q0 + i] : 0;
  __syncthreads();
  const int qm_r[2] = {qms[wr + g], qms[wr + g + 8]};
  const int qpos[2] = {q_offset + q0 + wr + g, q_offset + q0 + wr + g + 8};

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int k_end = causal ? min(Skv, q_offset + q0 + BQ) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();
    load_rows<D>(Ks, k, b, k0, BKV, Skv, KVH, kvh);
    load_rows<D>(Vs, v, b, k0, BKV, Skv, KVH, kvh);
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      kms[i] = k0 + i < Skv ? kmeta[(size_t)b * Skv + k0 + i] : 0;
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      frag_a(a, Qs, LD, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        frag_b_nk(bb, Ks, LD, n * 8, kk, g, t);
        mma16816(s[n], a, bb);
      }
    }
    uint32_t ok = 0;  // bit n*4+e: entry (n, e) is allowed
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = n * 8 + 2 * t + (e & 1);
        const bool a_ok = allowed(qm_r[r], kms[col]) &&
                          (!causal || qpos[r] >= k0 + col);
        const float val = a_ok ? s[n][e] * scale : NEG;
        ok |= (uint32_t)a_ok << (n * 4 + e);
        s[n][e] = val;
        mx[r] = fmaxf(mx[r], val);
      }
    float alpha[2], mnew[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mnew[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - mnew[r]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = (ok >> (n * 4 + e)) & 1u ? __expf(s[n][e] - mnew[r]) : 0.f;
        s[n][e] = p;
        ls[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = alpha[r] * l[r] + quad_sum(ls[r]);
      m[r] = mnew[r];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        uint32_t bb[2];
        frag_b_kn(bb, Vs, LD, kk * 16, i * 8, g, t);
        mma16816(acc[i], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= Sq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / safe;
    bf16* o = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(o + i * 8 + 2 * t) =
          pack_f(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    if (t == 0) lse[((size_t)b * H + h) * Sq + row] = m[r] + logf(safe);
  }
}

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  static constexpr int BYTES = (2 * BQ + 2 * BKV) * LD * 2 + (3 * BQ + BKV) * 4;
};

// dq = scale * sum_k dS K, dS = P * (dP - delta). grid (ceil(Sq / 64), H, B)
template <int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const int* __restrict__ qmeta, const int* __restrict__ kmeta,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Sq, int Skv, int H, int KVH,
              int causal, int q_offset, float scale) {
  constexpr int LD = D + 8, NT = BKV / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;  // dO
  bf16* Ks = Os + BQ * LD;
  bf16* Vs = Ks + BKV * LD;
  int* qms = reinterpret_cast<int*>(Vs + BKV * LD);
  int* kms = qms + BQ;
  float* lse_s = reinterpret_cast<float*>(kms + BKV);
  float* del_s = lse_s + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  load_rows<D>(Qs, q, b, q0, BQ, Sq, H, h);
  load_rows<D>(Os, dout, b, q0, BQ, Sq, H, h);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool in = q0 + i < Sq;
    const size_t hr = ((size_t)b * H + h) * Sq + q0 + i;
    qms[i] = in ? qmeta[(size_t)b * Sq + q0 + i] : 0;
    lse_s[i] = in ? lse[hr] : 0.f;
    del_s[i] = in ? delta[hr] : 0.f;
  }
  __syncthreads();
  const int qm_r[2] = {qms[wr + g], qms[wr + g + 8]};
  const int qpos[2] = {q_offset + q0 + wr + g, q_offset + q0 + wr + g + 8};
  const float lse_r[2] = {lse_s[wr + g], lse_s[wr + g + 8]};
  const float del_r[2] = {del_s[wr + g], del_s[wr + g + 8]};

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int k_end = causal ? min(Skv, q_offset + q0 + BQ) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();
    load_rows<D>(Ks, k, b, k0, BKV, Skv, KVH, kvh);
    load_rows<D>(Vs, v, b, k0, BKV, Skv, KVH, kvh);
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      kms[i] = k0 + i < Skv ? kmeta[(size_t)b * Skv + k0 + i] : 0;
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], ao[4];
      frag_a(a, Qs, LD, wr, kk, g, t);
      frag_a(ao, Os, LD, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        frag_b_nk(bb, Ks, LD, n * 8, kk, g, t);
        mma16816(s[n], a, bb);
        frag_b_nk(bb, Vs, LD, n * 8, kk, g, t);
        mma16816(dp[n], ao, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = n * 8 + 2 * t + (e & 1);
        const bool a_ok = allowed(qm_r[r], kms[col]) &&
                          (!causal || qpos[r] >= k0 + col);
        const float p = a_ok ? __expf(s[n][e] * scale - lse_r[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - del_r[r]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        uint32_t bb[2];
        frag_b_kn(bb, Ks, LD, kk * 16, i * 8, g, t);
        mma16816(acc[i], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= Sq) continue;
    bf16* o = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(o + i * 8 + 2 * t) =
          pack_f(acc[i][2 * r] * scale, acc[i][2 * r + 1] * scale);
  }
}

// Inner q tile of the dk/dv kernel: two [16, D] accumulators per warp leave
// fewer registers for the transposed scores at D = 128.
template <int D>
struct DkvCfg {
  static constexpr int BQI = D >= 128 ? 32 : 64;
  static constexpr int LD = D + 8;
  static constexpr int BYTES = (2 * BKV + 2 * BQI) * LD * 2 + (BKV + 3 * BQI) * 4;
};

// dv = sum_q P^T dO, dk = scale * sum_q dS^T Q over the group's q heads.
// grid (ceil(Skv / 64), KVH, B); warp w owns keys [16w, 16w + 16) of the block.
template <int D>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const int* __restrict__ qmeta, const int* __restrict__ kmeta,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
               int H, int KVH, int causal, int q_offset, float scale) {
  constexpr int BQI = DkvCfg<D>::BQI, LD = D + 8, NT = BQI / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;
  bf16* Os = Qs + BQI * LD;  // dO
  int* kms = reinterpret_cast<int*>(Os + BQI * LD);
  int* qms = kms + BKV;
  float* lse_s = reinterpret_cast<float*>(qms + BQI);
  float* del_s = lse_s + BQI;
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  load_rows<D>(Ks, k, b, k0, BKV, Skv, KVH, kvh);
  load_rows<D>(Vs, v, b, k0, BKV, Skv, KVH, kvh);
  for (int i = threadIdx.x; i < BKV; i += THREADS)
    kms[i] = k0 + i < Skv ? kmeta[(size_t)b * Skv + k0 + i] : 0;
  __syncthreads();
  const int km_r[2] = {kms[wr + g], kms[wr + g + 8]};
  const int kpos[2] = {k0 + wr + g, k0 + wr + g + 8};

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = 0; j < G; ++j) {
    const int h = kvh * G + j;
    for (int q0 = 0; q0 < Sq; q0 += BQI) {
      if (causal && q_offset + q0 + BQI - 1 < k0) continue;  // block-uniform
      __syncthreads();
      load_rows<D>(Qs, q, b, q0, BQI, Sq, H, h);
      load_rows<D>(Os, dout, b, q0, BQI, Sq, H, h);
      for (int i = threadIdx.x; i < BQI; i += THREADS) {
        const bool in = q0 + i < Sq;
        const size_t hr = ((size_t)b * H + h) * Sq + q0 + i;
        qms[i] = in ? qmeta[(size_t)b * Sq + q0 + i] : 0;
        lse_s[i] = in ? lse[hr] : 0.f;
        del_s[i] = in ? delta[hr] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns q
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        frag_a(ak, Ks, LD, wr, kk, g, t);
        frag_a(av, Vs, LD, wr, kk, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bb[2];
          frag_b_nk(bb, Qs, LD, n * 8, kk, g, t);
          mma16816(st[n], ak, bb);
          frag_b_nk(bb, Os, LD, n * 8, kk, g, t);
          mma16816(dpt[n], av, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = n * 8 + 2 * t + (e & 1);
          const bool a_ok = allowed(qms[col], km_r[r]) &&
                            (!causal || q_offset + q0 + col >= kpos[r]);
          const float p = a_ok ? __expf(st[n][e] * scale - lse_s[col]) : 0.f;
          st[n][e] = p;                            // P^T
          dpt[n][e] = p * (dpt[n][e] - del_s[col]);  // dS^T
        }
#pragma unroll
      for (int kk = 0; kk < BQI / 16; ++kk) {
        uint32_t ap[4], as[4];
        c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        c_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          uint32_t bb[2];
          frag_b_kn(bb, Os, LD, kk * 16, i * 8, g, t);
          mma16816(dva[i], ap, bb);
          frag_b_kn(bb, Qs, LD, kk * 16, i * 8, g, t);
          mma16816(dka[i], as, bb);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wr + g + 8 * r;
    if (row >= Skv) continue;
    const size_t off = (((size_t)b * Skv + row) * KVH + kvh) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<uint32_t*>(dk + off + i * 8 + 2 * t) =
          pack_f(dka[i][2 * r] * scale, dka[i][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + i * 8 + 2 * t) =
          pack_f(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const void* qm,
        const void* km, void* out, void* lse, int B, int Sq, int Skv, int H,
        int KVH, int causal, int q_offset, float scale, cudaStream_t st) {
  const int bytes = FwdSmem<D>::BYTES;
  if (int e = set_smem(fwd_kernel<D>, bytes)) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<D><<<grid, THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)qm,
      (const int*)km, (bf16*)out, (float*)lse, Sq, Skv, H, KVH, causal,
      q_offset, scale);
  RETURN_IF_ERR();
  return 0;
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* qm, const void* km, const void* lse, const void* delta,
        void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
        int causal, int q_offset, float scale, cudaStream_t st) {
  const int dq_bytes = DqSmem<D>::BYTES, dkv_bytes = DkvCfg<D>::BYTES;
  if (int e = set_smem(dq_kernel<D>, dq_bytes)) return e;
  if (int e = set_smem(dkv_kernel<D>, dkv_bytes)) return e;
  dim3 gq((Sq + BQ - 1) / BQ, H, B);
  dq_kernel<D><<<gq, THREADS, dq_bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const int*)qm, (const int*)km, (const float*)lse, (const float*)delta,
      (bf16*)dq, Sq, Skv, H, KVH, causal, q_offset, scale);
  RETURN_IF_ERR();
  dim3 gk((Skv + BKV - 1) / BKV, KVH, B);
  dkv_kernel<D><<<gk, THREADS, dkv_bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const int*)qm, (const int*)km, (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, Sq, Skv, H, KVH, causal, q_offset, scale);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace fa

// out [B, Sq, H, D] bf16, lse [B, H, Sq] fp32. D is 64 or 128.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_meta, const void* kv_meta,
                                   void* out, void* lse, int B, int Sq, int Skv,
                                   int H, int KVH, int D, int causal,
                                   int q_offset, float scale, void* stream) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return fa::fwd<64>(q, k, v, q_meta, kv_meta, out, lse, B, Sq, Skv, H, KVH,
                       causal, q_offset, scale, st);
  if (D == 128)
    return fa::fwd<128>(q, k, v, q_meta, kv_meta, out, lse, B, Sq, Skv, H, KVH,
                        causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// dq [B, Sq, H, D], dk/dv [B, Skv, KVH, D] bf16; delta [B, H, Sq] fp32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* q_meta,
                                   const void* kv_meta, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Skv, int H,
                                   int KVH, int D, int causal, int q_offset,
                                   float scale, void* stream) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return fa::bwd<64>(q, k, v, dout, q_meta, kv_meta, lse, delta, dq, dk, dv,
                       B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
  if (D == 128)
    return fa::bwd<128>(q, k, v, dout, q_meta, kv_meta, lse, delta, dq, dk, dv,
                        B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
