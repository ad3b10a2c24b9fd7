// Flash attention, forward and backward, for Hopper (bf16 in, fp32 softmax).
//
// Replaces: vlaser_tpu/kernels/flash_attention.py :: flash_attention_fwd
// (_flash_fwd_kernel, pallas_call at :206) and flash_attention_bwd
// (_flash_bwd_dq_kernel at :449 and _flash_bwd_dkv_kernel at :488).
//
// What it computes: q [B, Sq, H, D], k/v [B, Skv, KVH, D] (GQA: head h reads
// kv head h / (H / KVH)), D one of 64, 72, 128, 256; a key is allowed iff
// q_seg == k_seg, k_seg != 0 and k_lev <= q_lev (per-token metadata packed as
// seg << 2 | lev), when causal q_pos >= k_pos, and with a window q_pos - k_pos
// <= window (flash-attn's left window; q_pos = q_offset + q_idx). The logit
// is z = scale * q.k, or cap * tanh(z / cap) with a softcap (Gemma), taken
// before the mask as in the JAX kernel; lse is over the capped logits.
// Softmax statistics are fp32. A row with no allowed key gives out = 0 and
// lse = -1e30 + log(1). The backward recomputes P from lse, multiplies dS by
// the cap's derivative 1 - tanh^2, and takes delta = rowsum(dO * O) from the
// wrapper. The softcap is a template flag (the kernels without it carry no
// tanh and no branch on it); causal and window become per-row position
// bounds, two compares an element behind one uniform test (none without
// either). tanh is the accurate tanhf:
// tanh.approx's ~2^-11 relative error times a cap of 50 would move a logit
// by ~0.025.
//
// What bounds it on the H100: at the training shapes (InternViT: B=32,
// S=1025, 16 heads x 64; SigLIP: B=32, S=256, 16 x 72; the joint stacks: B=32,
// S=389, 12 q / 2 kv heads x 128 and S=281, 8 q / 1 kv heads x 256) the work
// is 4*B*H*Sq*Skv*D flop forward against q/k/v/o bytes, hundreds of flop per
// byte, so the tensor cores bound it (989 TFLOP/s bf16 dense). The serving
// suffix (4 query rows over 281 keys) is bound by reading K/V.
//
// What the design does about it: every product runs on the bf16 tensor cores
// (mma.sync m16n8k16, fp32 accumulation). A block of 4 warps owns 64 query
// rows (16 per warp) and walks key tiles held in shared memory, so each K/V
// tile is read once per 64 queries; P never leaves registers (the
// accumulator fragment of S is re-packed as the A operand of P.V). The
// backward keeps the TPU kernels' split so that no float atomics are needed:
// one kernel gives dq (a block per 64 q rows, looping over k tiles), one gives
// dk and dv (a block per (b, kv head, 64 keys), looping over the group's q
// heads and q tiles), which also sums GQA's group in registers. Masks and the
// -1e30 sentinel stay fp32 (-1e30 overflows half precision), masked entries
// are selected to 0 rather than multiplied (exp(s - lse) of a fully masked
// row is inf, and inf * 0 is NaN), and the ragged tile edges (S = 1025, 389,
// 281) read zeros with metadata 0, which the segment rule masks. Causal and
// window skip whole tiles that no pair of theirs may see.
// Head dims: the products step 16 deep, so D = 72 is padded to 80 in shared
// memory with zero columns (global rows are read only to their 72 elements:
// the next 8 belong to another head). At D = 256 a warp's [16, 256] fp32
// accumulator is 128 registers a thread: the forward and dq kernels take
// 32-key tiles there (their score fragments halve), and the dk/dv kernel
// splits D into two 128-wide slices over the grid (two [16, 256]
// accumulators a warp, 256 registers, cannot fit), each block recomputing
// S and dP for its slice. Simple first: tiles load synchronously (no
// cp.async / TMA) and there is no wgmma.
#include <climits>

#include "common.cuh"

namespace fa {

constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per block of the dk/dv kernel
constexpr float NEG = -1e30f;

// Per head dim: DP = D rounded up to the mma depth (the pad columns are zeros
// in shared memory); LD = DP + 8, the row pitch of a shared tile (16-byte
// aligned rows, conflict-free fragment loads); BKV = keys per tile of the
// forward and dq kernels; DS = the dk/dv kernel's slice of D.
template <int D>
struct Dims {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int LD = DP + 8;
  static constexpr int BKV = D > 128 ? 32 : 64;
  static constexpr int DS = D > 128 ? 128 : D;
  static constexpr int NS = D / DS;
};

// The mask and logit options of one call.
struct Opts {
  int causal, q_offset, window;  // window < 0: none
  float scale, softcap;          // softcap 0: none
};

__device__ __forceinline__ bool by_pos(const Opts& o) {
  return o.causal || o.window >= 0;
}

// Keys a query at qpos may see by position: [lo, hi].
__device__ __forceinline__ int key_lo(int qpos, const Opts& o) {
  return o.window < 0 ? INT_MIN : qpos - o.window;
}
__device__ __forceinline__ int key_hi(int qpos, const Opts& o) {
  return o.causal ? qpos : INT_MAX;
}
// Queries a key at kpos is seen by: [lo, hi].
__device__ __forceinline__ int query_lo(int kpos, const Opts& o) {
  return o.causal ? kpos : INT_MIN;
}
__device__ __forceinline__ int query_hi(int kpos, const Opts& o) {
  return o.window < 0 ? INT_MAX : kpos + o.window;
}

// z = scale * s -> the logit; with CAP, cap * tanh(z / cap) and t its tanh.
template <bool CAP>
__device__ __forceinline__ float logit(float s, const Opts& o, float inv_cap,
                                       float& t) {
  const float z = s * o.scale;
  if constexpr (CAP) {
    t = tanhf(z * inv_cap);
    return o.softcap * t;
  }
  return z;
}

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
// rows past S, and the pad columns [D, DP), read zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ x,
                                          int b, int s0, int nrows, int S,
                                          int heads, int h) {
  constexpr int LD = Dims<D>::LD, CH = D / 8, CP = Dims<D>::DP / 8;
  for (int i = threadIdx.x; i < nrows * CP; i += THREADS) {
    const int r = i / CP, c = i % CP, s = s0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S && c < CH)
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

// First key tile of a query block that its window can see (0 without one).
__device__ __forceinline__ int k_first(int q_start, int bkv, const Opts& o) {
  return o.window < 0 ? 0 : max(0, q_start - o.window) / bkv * bkv;
}

template <int D>
struct FwdSmem {
  static constexpr int LD = Dims<D>::LD, BKV = Dims<D>::BKV;
  static constexpr int BYTES = (BQ + 2 * BKV) * LD * 2 + (BQ + BKV) * 4;
};

// grid (ceil(Sq / 64), H, B)
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ qmeta,
               const int* __restrict__ kmeta, bf16* __restrict__ out,
               float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
               Opts o) {
  constexpr int LD = Dims<D>::LD, DP = Dims<D>::DP, BKV = Dims<D>::BKV;
  constexpr int NT = BKV / 8, DT = D / 8;
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
  const float inv_cap = o.softcap > 0.f ? 1.f / o.softcap : 0.f;

  load_rows<D>(Qs, q, b, q0, BQ, Sq, H, h);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    qms[i] = q0 + i < Sq ? qmeta[(size_t)b * Sq + q0 + i] : 0;
  __syncthreads();
  const int qm_r[2] = {qms[wr + g], qms[wr + g + 8]};
  const int qpos[2] = {o.q_offset + q0 + wr + g, o.q_offset + q0 + wr + g + 8};
  const int klo[2] = {key_lo(qpos[0], o), key_lo(qpos[1], o)};
  const int khi[2] = {key_hi(qpos[0], o), key_hi(qpos[1], o)};
  const bool pos = by_pos(o);

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int k_end = o.causal ? min(Skv, o.q_offset + q0 + BQ) : Skv;
  for (int k0 = k_first(o.q_offset + q0, BKV, o); k0 < k_end; k0 += BKV) {
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
    for (int kk = 0; kk < DP; kk += 16) {
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
        const int r = e >> 1, col = n * 8 + 2 * t + (e & 1), kp = k0 + col;
        const bool a_ok = allowed(qm_r[r], kms[col]) &&
                          (!pos || (kp >= klo[r] && kp <= khi[r]));
        float tc;
        const float val = a_ok ? logit<CAP>(s[n][e], o, inv_cap, tc) : NEG;
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
    bf16* op = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(op + i * 8 + 2 * t) =
          pack_f(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    if (t == 0) lse[((size_t)b * H + h) * Sq + row] = m[r] + logf(safe);
  }
}

template <int D>
struct DqSmem {
  static constexpr int LD = Dims<D>::LD, BKV = Dims<D>::BKV;
  static constexpr int BYTES = (2 * BQ + 2 * BKV) * LD * 2 + (3 * BQ + BKV) * 4;
};

// dq = scale * sum_k dS K, dS = P * (dP - delta) (* (1 - t^2) with CAP).
// grid (ceil(Sq / 64), H, B)
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const int* __restrict__ qmeta, const int* __restrict__ kmeta,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Sq, int Skv, int H, int KVH, Opts o) {
  constexpr int LD = Dims<D>::LD, DP = Dims<D>::DP, BKV = Dims<D>::BKV;
  constexpr int NT = BKV / 8, DT = D / 8;
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
  const float inv_cap = o.softcap > 0.f ? 1.f / o.softcap : 0.f;

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
  const int qpos[2] = {o.q_offset + q0 + wr + g, o.q_offset + q0 + wr + g + 8};
  const int klo[2] = {key_lo(qpos[0], o), key_lo(qpos[1], o)};
  const int khi[2] = {key_hi(qpos[0], o), key_hi(qpos[1], o)};
  const bool pos = by_pos(o);
  const float lse_r[2] = {lse_s[wr + g], lse_s[wr + g + 8]};
  const float del_r[2] = {del_s[wr + g], del_s[wr + g + 8]};

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int k_end = o.causal ? min(Skv, o.q_offset + q0 + BQ) : Skv;
  for (int k0 = k_first(o.q_offset + q0, BKV, o); k0 < k_end; k0 += BKV) {
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
    for (int kk = 0; kk < DP; kk += 16) {
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
        const int r = e >> 1, col = n * 8 + 2 * t + (e & 1), kp = k0 + col;
        const bool a_ok = allowed(qm_r[r], kms[col]) &&
                          (!pos || (kp >= klo[r] && kp <= khi[r]));
        float tc;
        const float z = logit<CAP>(s[n][e], o, inv_cap, tc);
        const float p = a_ok ? __expf(z - lse_r[r]) : 0.f;
        float ds = p * (dp[n][e] - del_r[r]);
        if constexpr (CAP) ds *= 1.f - tc * tc;
        s[n][e] = ds;  // dS
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
    bf16* op = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(op + i * 8 + 2 * t) =
          pack_f(acc[i][2 * r] * o.scale, acc[i][2 * r + 1] * o.scale);
  }
}

// Inner q tile of the dk/dv kernel: two [16, DS] accumulators per warp leave
// fewer registers for the transposed scores at DS = 128.
template <int D>
struct DkvCfg {
  static constexpr int DS = Dims<D>::DS;
  static constexpr int BQI = DS >= 128 ? 32 : 64;
  static constexpr int LD = Dims<D>::LD;
  static constexpr int BYTES = (2 * BK + 2 * BQI) * LD * 2 + (BK + 3 * BQI) * 4;
};

// dv = sum_q P^T dO, dk = scale * sum_q dS^T Q over the group's q heads, for
// the slice [d0, d0 + DS) of D. grid (ceil(Skv / 64), KVH * NS, B); warp w
// owns keys [16w, 16w + 16) of the block.
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const int* __restrict__ qmeta, const int* __restrict__ kmeta,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
               int H, int KVH, Opts o) {
  constexpr int BQI = DkvCfg<D>::BQI, LD = Dims<D>::LD, DP = Dims<D>::DP;
  constexpr int DS = Dims<D>::DS, NS = Dims<D>::NS, NT = BQI / 8, DT = DS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* Os = Qs + BQI * LD;  // dO
  int* kms = reinterpret_cast<int*>(Os + BQI * LD);
  int* qms = kms + BK;
  float* lse_s = reinterpret_cast<float*>(qms + BQI);
  float* del_s = lse_s + BQI;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y / NS, b = blockIdx.z;
  const int d0 = (blockIdx.y % NS) * DS;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const float inv_cap = o.softcap > 0.f ? 1.f / o.softcap : 0.f;

  load_rows<D>(Ks, k, b, k0, BK, Skv, KVH, kvh);
  load_rows<D>(Vs, v, b, k0, BK, Skv, KVH, kvh);
  for (int i = threadIdx.x; i < BK; i += THREADS)
    kms[i] = k0 + i < Skv ? kmeta[(size_t)b * Skv + k0 + i] : 0;
  __syncthreads();
  const int km_r[2] = {kms[wr + g], kms[wr + g + 8]};
  const int kpos[2] = {k0 + wr + g, k0 + wr + g + 8};
  const int qlo[2] = {query_lo(kpos[0], o), query_lo(kpos[1], o)};
  const int qhi[2] = {query_hi(kpos[0], o), query_hi(kpos[1], o)};
  const bool pos = by_pos(o);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = 0; j < G; ++j) {
    const int h = kvh * G + j;
    for (int q0 = 0; q0 < Sq; q0 += BQI) {
      const int qs = o.q_offset + q0;  // block-uniform tile skips
      if (o.causal && qs + BQI - 1 < k0) continue;
      if (o.window >= 0 && qs - (k0 + BK - 1) > o.window) continue;
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
      for (int kk = 0; kk < DP; kk += 16) {
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
          const int r = e >> 1, col = n * 8 + 2 * t + (e & 1), qp = qs + col;
          const bool a_ok = allowed(qms[col], km_r[r]) &&
                            (!pos || (qp >= qlo[r] && qp <= qhi[r]));
          float tc;
          const float z = logit<CAP>(st[n][e], o, inv_cap, tc);
          const float p = a_ok ? __expf(z - lse_s[col]) : 0.f;
          float ds = p * (dpt[n][e] - del_s[col]);
          if constexpr (CAP) ds *= 1.f - tc * tc;
          st[n][e] = p;    // P^T
          dpt[n][e] = ds;  // dS^T
        }
#pragma unroll
      for (int kk = 0; kk < BQI / 16; ++kk) {
        uint32_t ap[4], as[4];
        c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        c_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          uint32_t bb[2];
          frag_b_kn(bb, Os, LD, kk * 16, d0 + i * 8, g, t);
          mma16816(dva[i], ap, bb);
          frag_b_kn(bb, Qs, LD, kk * 16, d0 + i * 8, g, t);
          mma16816(dka[i], as, bb);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wr + g + 8 * r;
    if (row >= Skv) continue;
    const size_t off = (((size_t)b * Skv + row) * KVH + kvh) * D + d0;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<uint32_t*>(dk + off + i * 8 + 2 * t) =
          pack_f(dka[i][2 * r] * o.scale, dka[i][2 * r + 1] * o.scale);
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

template <int D, bool CAP>
int fwd(const void* q, const void* k, const void* v, const void* qm,
        const void* km, void* out, void* lse, int B, int Sq, int Skv, int H,
        int KVH, Opts o, cudaStream_t st) {
  const int bytes = FwdSmem<D>::BYTES;
  if (int e = set_smem(fwd_kernel<D, CAP>, bytes)) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<D, CAP><<<grid, THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)qm,
      (const int*)km, (bf16*)out, (float*)lse, Sq, Skv, H, KVH, o);
  RETURN_IF_ERR();
  return 0;
}

template <int D, bool CAP>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* qm, const void* km, const void* lse, const void* delta,
        void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
        Opts o, cudaStream_t st) {
  const int dq_bytes = DqSmem<D>::BYTES, dkv_bytes = DkvCfg<D>::BYTES;
  if (int e = set_smem(dq_kernel<D, CAP>, dq_bytes)) return e;
  if (int e = set_smem(dkv_kernel<D, CAP>, dkv_bytes)) return e;
  dim3 gq((Sq + BQ - 1) / BQ, H, B);
  dq_kernel<D, CAP><<<gq, THREADS, dq_bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const int*)qm, (const int*)km, (const float*)lse, (const float*)delta,
      (bf16*)dq, Sq, Skv, H, KVH, o);
  RETURN_IF_ERR();
  dim3 gk((Skv + BK - 1) / BK, KVH * Dims<D>::NS, B);
  dkv_kernel<D, CAP><<<gk, THREADS, dkv_bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const int*)qm, (const int*)km, (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, Sq, Skv, H, KVH, o);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace fa

#define FA_HEAD_DIMS(X) X(64) X(72) X(128) X(256)

// out [B, Sq, H, D] bf16, lse [B, H, Sq] fp32. D is 64, 72, 128 or 256;
// softcap 0 = none, window < 0 = none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_meta, const void* kv_meta,
                                   void* out, void* lse, int B, int Sq, int Skv,
                                   int H, int KVH, int D, int causal,
                                   int q_offset, float scale, float softcap,
                                   int window, void* stream) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  const fa::Opts o{causal, q_offset, window, scale, softcap};
  cudaStream_t st = (cudaStream_t)stream;
#define FA_FWD(DD)                                                          \
  if (D == DD)                                                              \
    return o.softcap > 0.f                                                  \
               ? fa::fwd<DD, true>(q, k, v, q_meta, kv_meta, out, lse, B,   \
                                   Sq, Skv, H, KVH, o, st)                  \
               : fa::fwd<DD, false>(q, k, v, q_meta, kv_meta, out, lse, B,  \
                                    Sq, Skv, H, KVH, o, st);
  FA_HEAD_DIMS(FA_FWD)
#undef FA_FWD
  return (int)cudaErrorInvalidValue;
}

// dq [B, Sq, H, D], dk/dv [B, Skv, KVH, D] bf16; delta [B, H, Sq] fp32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* q_meta,
                                   const void* kv_meta, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Skv, int H,
                                   int KVH, int D, int causal, int q_offset,
                                   float scale, float softcap, int window,
                                   void* stream) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  const fa::Opts o{causal, q_offset, window, scale, softcap};
  cudaStream_t st = (cudaStream_t)stream;
#define FA_BWD(DD)                                                          \
  if (D == DD)                                                              \
    return o.softcap > 0.f                                                  \
               ? fa::bwd<DD, true>(q, k, v, dout, q_meta, kv_meta, lse,     \
                                   delta, dq, dk, dv, B, Sq, Skv, H, KVH, o, \
                                   st)                                      \
               : fa::bwd<DD, false>(q, k, v, dout, q_meta, kv_meta, lse,    \
                                    delta, dq, dk, dv, B, Sq, Skv, H, KVH,  \
                                    o, st);
  FA_HEAD_DIMS(FA_BWD)
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
