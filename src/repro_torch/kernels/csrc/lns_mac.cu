// Hand-written Hopper (sm_90a) kernels for log-domain training: the
// sequential ⊞-MAC with its flush-time epilogues, the elementwise ⊞-SGD and
// the row-wise sequential ⊞-reduce.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   * lns_mac_launch    — src/repro/kernels/lns_matmul/lns_matmul.py:
//                         _mac_kernel (:236) as launched by
//                         lns_matmul_fused_pallas (:599),
//                         lns_matmul_dx_pallas (:539),
//                         lns_matmul_dw_update_pallas (:622),
//                         lns_matmul_pallas (:528),
//                         lns_matmul_dw_pallas (:555) and, with one
//                         contraction segment per grid z,
//                         lns_matmul_dw_partials_pallas (:571);
//   * lns_update_launch — src/repro/kernels/lns_matmul/update.py:
//                         _update_kernel (:35);
//   * lns_boxsum_launch — src/repro/kernels/lns_boxsum/lns_boxsum.py:
//                         _kernel (:28) as launched by
//                         lns_boxsum_pallas (:69).
//
// What bounds it on an H100: there is no multiply, so no tensor core can
// help.  Each ⊞-MAC step is ~46 dependent int32 ALU operations plus one
// Δ-table gather, and the steps of one output element form a serial
// chain: the contraction is walked in ascending order because ⊞ is only
// approximately associative and that order is the semantics.  At the
// training step's batch of 5 the grid is a handful of blocks and the time
// is the latency of that chain plus the launch; at large batch it is
// int32 instruction throughput.  The design therefore
//   * gives every output element one thread, which walks its contraction
//     serially (no split-K, no tree, no atomics);
//   * stages chunks of both operands in shared memory with coalesced
//     loads, reading transposed operands through strides (no transpose is
//     materialised), and masks ragged edges with the zero code, the ⊞
//     identity;
//   * keeps the Δ LUT (20 to 1024 entries) in shared memory, copied once
//     per block;
//   * applies the epilogue (bias ⊞ / llReLU / requantize, or the ⊞-SGD
//     update) to the accumulator in registers, so neither the
//     pre-activation nor the weight gradient is ever stored.
//
// Every device function below mirrors a function of the Pallas source op
// for op; the Python wrappers (kernels/lns_matmul/*.py) hold the plain
// PyTorch versions the kernels are checked against bit for bit.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// into a shared library with a plain C interface (see kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileR = 8;    // output rows per block
constexpr int kTileC = 32;   // output columns per block (one warp)
constexpr int kTileK = 32;   // contraction chunk staged in shared memory
constexpr int kThreads = kTileR * kTileC;
constexpr int kMaxTab = 1024;
constexpr int kUpdateThreads = 256;
constexpr int kBoxsumThreads = 256;

enum DeltaKind : int { kLut = 0, kBitshift = 1, kExact = 2 };
enum Epilogue : int { kEpiNone = 0, kEpiFwd = 1, kEpiUpdate = 2 };

}  // namespace

// Parameter blocks shared with ctypes (kernels/build.py).  Every field is
// 8 bytes wide, so the layout has no padding and the Python mirror is a
// plain list of c_int64 / c_void_p fields in the same order.
struct LnsArgs {
  int64_t qf, code_max, min_nz, zero_code;
  int64_t delta_kind, n_tab, r_code, underflow;
  const int32_t* tab_plus;
  const int32_t* tab_minus;
};

struct SgdArgs {
  int64_t lr_code;
  int64_t mom_on, mom_code;
  int64_t wd_on, wd_code;
};

struct MacParams {
  LnsArgs lns;
  // A's element (r, t) is at a[r * a_sr + t * a_st]; B's (t, c) at
  // b[t * b_st + c * b_sc]; t runs over the contraction.
  const int32_t* a_code;
  const int8_t* a_sign;
  int64_t a_sr, a_st;
  const int32_t* b_code;
  const int8_t* b_sign;
  int64_t b_st, b_sc;
  // S contraction segments of CT steps each, one per grid z: segment z
  // reads steps [z * CT, (z + 1) * CT) of the operands and writes its
  // output slot at z * R * C.  S = 1 walks the whole contraction.
  int64_t R, C, CT, S;
  int64_t epilogue;
  // Forward epilogue (FwdEpilogue): a null bias pointer means no bias.
  const int32_t* bias_code;
  const int8_t* bias_sign;
  int64_t llrelu_on, beta;
  int64_t dst_on, dst_qf, dst_code_max, dst_min_nz, dst_zero;
  int8_t* z_sign_out;  // null unless emit_z_sign
  // Update epilogue (UpdateEpilogue) against the resident (R, C) w / m.
  SgdArgs sgd;
  const int32_t* w_code;
  const int8_t* w_sign;
  const int32_t* m_code;
  const int8_t* m_sign;
  int32_t* m_code_out;
  int8_t* m_sign_out;
  // (R, C) row-major outputs.
  int32_t* out_code;
  int8_t* out_sign;
};

struct UpdateParams {
  LnsArgs lns;
  SgdArgs sgd;
  int64_t n;
  const int32_t* w_code;
  const int8_t* w_sign;
  const int32_t* g_code;
  const int8_t* g_sign;
  const int32_t* m_code;
  const int8_t* m_sign;
  int32_t* w_code_out;
  int8_t* w_sign_out;
  int32_t* m_code_out;
  int8_t* m_sign_out;
};

// The ⊞-reduce of `rows` rows of `steps` elements: row i's step s is at
// code[i * row_stride + s * step_stride] (likewise sign).
struct BoxsumParams {
  LnsArgs lns;
  const int32_t* code;
  const int8_t* sign;
  int64_t rows, steps, row_stride, step_stride;
  int32_t* out_code;
  int8_t* out_sign;
};

static_assert(sizeof(LnsArgs) == 10 * 8, "LnsArgs layout");
static_assert(sizeof(SgdArgs) == 5 * 8, "SgdArgs layout");

namespace {

// The format and Δ engine of one launch, in registers.  ``tp``/``tm``
// point at the Δ tables (shared memory in the MAC kernel, global in the
// update kernel).
struct Lns {
  int qf, code_max, min_nz, zero, n_tab, r_code, underflow;
  float scale;
  const int32_t* tp;
  const int32_t* tm;
};

__device__ __forceinline__ Lns make_lns(const LnsArgs& a, const int32_t* tp,
                                        const int32_t* tm) {
  Lns k;
  k.qf = (int)a.qf;
  k.code_max = (int)a.code_max;
  k.min_nz = (int)a.min_nz;
  k.zero = (int)a.zero_code;
  k.n_tab = (int)a.n_tab;
  k.r_code = (int)a.r_code;
  k.underflow = (int)a.underflow;
  k.scale = (float)(1 << a.qf);
  k.tp = tp;
  k.tm = tm;
  return k;
}

// _delta_from_tables (lns_matmul.py:60): nearest-sample LUT, Δ := 0 past
// the table, Δ-(0) = underflow sentinel.  d >= 0.
__device__ __forceinline__ int delta_lut(int d, bool same, const Lns& k) {
  int idx = (d + k.r_code / 2) / k.r_code;
  bool oob = idx >= k.n_tab;
  int idx_c = min(max(idx, 0), k.n_tab - 1);
  if (same) return oob ? 0 : k.tp[idx_c];
  if (d == 0) return k.underflow;
  return oob ? 0 : k.tm[idx_c];
}

// _delta_bitshift (lns_matmul.py:84): eq. (9).  d_int is capped at 30 so
// no shift reaches 32.
__device__ __forceinline__ int delta_bitshift(int d, bool same,
                                              const Lns& k) {
  int d_int = min(d >> k.qf, 30);
  if (same) return (1 << k.qf) >> d_int;
  if (d == 0) return k.underflow;
  return -((3 << k.qf) >> (d_int + 1));
}

// float32 log2 / exp2 / expm1 as jax.numpy lowers them (log(x) / ln 2,
// exp(ln 2 · x)), each elementary function taken in double and rounded
// once to float: the same values as repro_torch/core/f32.py on either
// device, independent of how the work is split.
constexpr float kLn2 = 0.693147182464599609375f;  // float32(ln 2)

__device__ __forceinline__ float log2_f32(float x) {
  return (float)log((double)x) / kLn2;
}

__device__ __forceinline__ float exp2_f32(float x) {
  return (float)exp((double)(kLn2 * x));
}

__device__ __forceinline__ float expm1_f32(float x) {
  return (float)expm1((double)x);
}

// _delta_exact (lns_matmul.py:72): float32 Δ±, rounded half to even like
// jnp.round.
__device__ __forceinline__ int delta_exact(int d, bool same, const Lns& k) {
  if (same) {
    float x = (float)d / k.scale;
    return (int)rintf(log2_f32(1.0f + exp2_f32(-x)) * k.scale);
  }
  if (d <= 0) return k.underflow;
  float x = (float)d / k.scale;
  return (int)rintf(log2_f32(-expm1_f32(-x * kLn2)) * k.scale);
}

template <int KIND>
__device__ __forceinline__ int delta(int d, bool same, const Lns& k) {
  if (KIND == kLut) return delta_lut(d, same, k);
  if (KIND == kBitshift) return delta_bitshift(d, same, k);
  return delta_exact(d, same, k);
}

// _boxplus_codes (lns_matmul.py:93): ⊞ on (code, sign) pairs.
template <int KIND>
__device__ __forceinline__ void boxplus(int ac, int as, int bc, int bs,
                                        const Lns& k, int& oc, int& os) {
  bool za = ac == k.zero;
  bool zb = bc == k.zero;
  int m = max(ac, bc);
  int d = abs(ac - bc);
  bool same = as == bs;
  int code = min(m + delta<KIND>(d, same, k), k.code_max);
  if (code < k.min_nz) code = k.zero;
  if (!same && d == 0) code = k.zero;
  int sign = (same || ac > bc) ? as : bs;
  if (za) {
    code = bc;
    sign = bs;
  } else if (zb) {
    code = ac;
    sign = as;
  }
  oc = code;
  os = code == k.zero ? 0 : sign;
}

// _scalar_boxdot_codes (lns_matmul.py:199): ⊡ by a positive nonzero
// scalar code.
__device__ __forceinline__ void scalar_boxdot(int s, int tc, int ts,
                                              const Lns& k, int& oc,
                                              int& os) {
  bool zt = tc == k.zero;
  int code = min(tc + s, k.code_max);
  if (code < k.min_nz) code = k.zero;
  oc = zt ? k.zero : code;
  os = zt ? 0 : ts;
}

// _apply_update_epilogue (lns_matmul.py:214): ⊞-SGD of one element.
//   M ← (μ ⊡ M) ⊞ G;  W ← W ⊟ (lr ⊡ M) ⊟ (lrλ ⊡ W)
template <int KIND>
__device__ __forceinline__ void sgd_update(int& wc, int& ws, int& mc,
                                           int& ms, int gc, int gs,
                                           const SgdArgs& sgd,
                                           const Lns& k) {
  int tc, ts;
  if (sgd.mom_on) {
    scalar_boxdot((int)sgd.mom_code, mc, ms, k, tc, ts);
    boxplus<KIND>(tc, ts, gc, gs, k, mc, ms);
    gc = mc;
    gs = ms;
  }
  scalar_boxdot((int)sgd.lr_code, gc, gs, k, tc, ts);
  boxplus<KIND>(wc, ws, tc, ts ^ 1, k, wc, ws);
  if (sgd.wd_on) {
    scalar_boxdot((int)sgd.wd_code, wc, ws, k, tc, ts);
    boxplus<KIND>(wc, ws, tc, ts ^ 1, k, wc, ws);
  }
}

// _mac_kernel (lns_matmul.py:236) with the epilogues of :165 and :214, and
// its partial flush (:300, :343): grid z walks contraction segment z alone
// into its own output slot.
template <int KIND>
__global__ void __launch_bounds__(kThreads) mac_kernel(const MacParams p) {
  __shared__ int32_t s_tp[kMaxTab];
  __shared__ int32_t s_tm[kMaxTab];
  __shared__ int32_t s_ac[kTileR][kTileK + 1];
  __shared__ int8_t s_as[kTileR][kTileK + 1];
  __shared__ int32_t s_bc[kTileK][kTileC + 1];
  __shared__ int8_t s_bs[kTileK][kTileC + 1];

  const int tid = threadIdx.x;
  const int tr = tid / kTileC;
  const int tc = tid % kTileC;
  const int64_t r0 = (int64_t)blockIdx.y * kTileR;
  const int64_t c0 = (int64_t)blockIdx.x * kTileC;
  const int64_t r = r0 + tr;
  const int64_t c = c0 + tc;

  if (KIND == kLut) {
    for (int i = tid; i < p.lns.n_tab; i += kThreads) {
      s_tp[i] = p.lns.tab_plus[i];
      s_tm[i] = p.lns.tab_minus[i];
    }
  }
  const Lns k = make_lns(p.lns, s_tp, s_tm);

  // The loop walks the segment's own steps; t_lo moves only the global
  // reads, so that S = 1 runs the loop of the unsegmented kernel.
  const int64_t t_lo = (int64_t)blockIdx.z * p.CT;
  int acc_c = k.zero;
  int acc_s = 0;
  for (int64_t t0 = 0; t0 < p.CT; t0 += kTileK) {
    // Stage A[r0:r0+8, t0:t0+32]: one element a thread, the unit-stride
    // axis fastest so that neighbouring threads read neighbouring words.
    {
      int lr, lt;
      if (p.a_st == 1) {
        lr = tid / kTileK;
        lt = tid % kTileK;
      } else {
        lt = tid / kTileR;
        lr = tid % kTileR;
      }
      int64_t gr = r0 + lr, gt = t0 + lt;
      bool in = gr < p.R && gt < p.CT;
      int64_t off = gr * p.a_sr + (t_lo + gt) * p.a_st;
      s_ac[lr][lt] = in ? p.a_code[off] : k.zero;
      s_as[lr][lt] = in ? p.a_sign[off] : (int8_t)0;
    }
    // Stage B[t0:t0+32, c0:c0+32]: four elements a thread.
    for (int q = 0; q < (kTileK * kTileC) / kThreads; ++q) {
      int l = tid + q * kThreads;
      int lt, lc;
      if (p.b_sc == 1) {
        lt = l / kTileC;
        lc = l % kTileC;
      } else {
        lc = l / kTileK;
        lt = l % kTileK;
      }
      int64_t gt = t0 + lt, gc = c0 + lc;
      bool in = gt < p.CT && gc < p.C;
      int64_t off = (t_lo + gt) * p.b_st + gc * p.b_sc;
      s_bc[lt][lc] = in ? p.b_code[off] : k.zero;
      s_bs[lt][lc] = in ? p.b_sign[off] : (int8_t)0;
    }
    __syncthreads();
    const int64_t rem = p.CT - t0;
    const int nt = rem < kTileK ? (int)rem : kTileK;
    for (int i = 0; i < nt; ++i) {
      // The product step (lns_matmul.py:330-335), then ⊞ into the
      // accumulator, in ascending contraction order.
      int a_c = s_ac[tr][i], b_c = s_bc[i][tc];
      bool pz = a_c == k.zero || b_c == k.zero;
      int pc = min(a_c + b_c, k.code_max);
      if (pc < k.min_nz) pc = k.zero;
      if (pz) pc = k.zero;
      int ps = pz ? 0 : (s_as[tr][i] ^ s_bs[i][tc]);
      boxplus<KIND>(acc_c, acc_s, pc, ps, k, acc_c, acc_s);
    }
    __syncthreads();
  }
  if (r >= p.R || c >= p.C) return;
  const int64_t o = (int64_t)blockIdx.z * p.R * p.C + r * p.C + c;
  int code = acc_c, sign = acc_s;

  if (p.epilogue == kEpiFwd) {
    // _apply_fwd_epilogue (lns_matmul.py:165): bias ⊞ → llReLU →
    // requantize; z_sign is the post-bias sign.
    if (p.bias_code != nullptr)
      boxplus<KIND>(code, sign, p.bias_code[c], p.bias_sign[c], k, code,
                    sign);
    const int z_sign = sign;
    if (p.llrelu_on) {
      int shifted = code + (int)p.beta;
      if (shifted < k.min_nz) shifted = k.zero;
      int act = sign == 1 ? shifted : code;
      code = code == k.zero ? k.zero : act;
    }
    if (p.dst_on) {
      // Barrel shift onto the destination grid; narrowing rounds half up
      // through an arithmetic right shift of the (possibly negative) code.
      const int shift = (int)p.dst_qf - k.qf;
      int conv = shift >= 0 ? code * (1 << shift)
                            : (code + (1 << (-shift - 1))) >> (-shift);
      const bool is_zero = code == k.zero || conv < (int)p.dst_min_nz;
      conv = min(max(conv, (int)p.dst_min_nz), (int)p.dst_code_max);
      code = is_zero ? (int)p.dst_zero : conv;
      if (is_zero) sign = 0;
    }
    if (p.z_sign_out != nullptr) p.z_sign_out[o] = (int8_t)z_sign;
  } else if (p.epilogue == kEpiUpdate) {
    int wc = p.w_code[o], ws = p.w_sign[o];
    int mc = 0, ms = 0;
    if (p.sgd.mom_on) {
      mc = p.m_code[o];
      ms = p.m_sign[o];
    }
    sgd_update<KIND>(wc, ws, mc, ms, code, sign, p.sgd, k);
    code = wc;
    sign = ws;
    if (p.sgd.mom_on) {
      p.m_code_out[o] = mc;
      p.m_sign_out[o] = (int8_t)ms;
    }
  }
  p.out_code[o] = code;
  p.out_sign[o] = (int8_t)sign;
}

// _update_kernel (update.py:35): the ⊞-SGD, one thread per element.
template <int KIND>
__global__ void __launch_bounds__(kUpdateThreads)
    update_kernel(const UpdateParams p) {
  const int64_t i = (int64_t)blockIdx.x * kUpdateThreads + threadIdx.x;
  if (i >= p.n) return;
  const Lns k = make_lns(p.lns, p.lns.tab_plus, p.lns.tab_minus);
  int wc = p.w_code[i], ws = p.w_sign[i];
  int mc = 0, ms = 0;
  if (p.sgd.mom_on) {
    mc = p.m_code[i];
    ms = p.m_sign[i];
  }
  sgd_update<KIND>(wc, ws, mc, ms, p.g_code[i], p.g_sign[i], p.sgd, k);
  p.w_code_out[i] = wc;
  p.w_sign_out[i] = (int8_t)ws;
  if (p.sgd.mom_on) {
    p.m_code_out[i] = mc;
    p.m_sign_out[i] = (int8_t)ms;
  }
}

// _kernel (lns_boxsum.py:28): one thread per row folds the row's steps
// in ascending order into one accumulator.  The row's steps are a serial
// chain of ⊞ (~36 int32 operations each) and every element is read once,
// so at the data-parallel combine's shapes (up to 78400 rows of 5 steps:
// 2.4 MB and 14 M operations, about a microsecond either way) the launch
// dominates.  Rows and steps are read through strides: the combine passes
// its (S, E) partials in place, where a warp's 32 rows are 32 neighbouring
// words at every step.
template <int KIND>
__global__ void __launch_bounds__(kBoxsumThreads)
    boxsum_kernel(const BoxsumParams p) {
  __shared__ int32_t s_tp[kMaxTab];
  __shared__ int32_t s_tm[kMaxTab];
  if (KIND == kLut) {
    for (int i = threadIdx.x; i < p.lns.n_tab; i += kBoxsumThreads) {
      s_tp[i] = p.lns.tab_plus[i];
      s_tm[i] = p.lns.tab_minus[i];
    }
    __syncthreads();
  }
  const int64_t i = (int64_t)blockIdx.x * kBoxsumThreads + threadIdx.x;
  if (i >= p.rows) return;
  const Lns k = make_lns(p.lns, s_tp, s_tm);
  const int32_t* code = p.code + i * p.row_stride;
  const int8_t* sign = p.sign + i * p.row_stride;
  int acc_c = k.zero;
  int acc_s = 0;
  for (int64_t s = 0; s < p.steps; ++s) {
    const int64_t at = s * p.step_stride;
    boxplus<KIND>(acc_c, acc_s, code[at], sign[at], k, acc_c, acc_s);
  }
  p.out_code[i] = acc_c;
  p.out_sign[i] = (int8_t)acc_s;
}

}  // namespace

extern "C" {

int lns_mac_params_size() { return (int)sizeof(MacParams); }
int lns_update_params_size() { return (int)sizeof(UpdateParams); }
int lns_boxsum_params_size() { return (int)sizeof(BoxsumParams); }
int lns_max_table() { return kMaxTab; }
const char* lns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues one ⊞-MAC launch on ``stream``; returns cudaGetLastError().
int lns_mac_launch(const MacParams* p, void* stream) {
  if (p->lns.n_tab > kMaxTab) return (int)cudaErrorInvalidValue;
  // Segments take no epilogue; the grid z extent holds at most 65535.
  if (p->S < 1 || p->S > 65535 || (p->S > 1 && p->epilogue != kEpiNone))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((p->C + kTileC - 1) / kTileC),
            (unsigned)((p->R + kTileR - 1) / kTileR), (unsigned)p->S);
  cudaStream_t s = (cudaStream_t)stream;
  switch (p->lns.delta_kind) {
    case kLut: mac_kernel<kLut><<<grid, kThreads, 0, s>>>(*p); break;
    case kBitshift: mac_kernel<kBitshift><<<grid, kThreads, 0, s>>>(*p); break;
    case kExact: mac_kernel<kExact><<<grid, kThreads, 0, s>>>(*p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Enqueues one elementwise ⊞-SGD launch; returns cudaGetLastError().
int lns_update_launch(const UpdateParams* p, void* stream) {
  dim3 grid((unsigned)((p->n + kUpdateThreads - 1) / kUpdateThreads));
  cudaStream_t s = (cudaStream_t)stream;
  switch (p->lns.delta_kind) {
    case kLut: update_kernel<kLut><<<grid, kUpdateThreads, 0, s>>>(*p); break;
    case kBitshift:
      update_kernel<kBitshift><<<grid, kUpdateThreads, 0, s>>>(*p);
      break;
    case kExact: update_kernel<kExact><<<grid, kUpdateThreads, 0, s>>>(*p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Enqueues one ⊞-reduce launch; returns cudaGetLastError().
int lns_boxsum_launch(const BoxsumParams* p, void* stream) {
  if (p->lns.n_tab > kMaxTab) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((p->rows + kBoxsumThreads - 1) / kBoxsumThreads));
  cudaStream_t s = (cudaStream_t)stream;
  switch (p->lns.delta_kind) {
    case kLut: boxsum_kernel<kLut><<<grid, kBoxsumThreads, 0, s>>>(*p); break;
    case kBitshift:
      boxsum_kernel<kBitshift><<<grid, kBoxsumThreads, 0, s>>>(*p);
      break;
    case kExact:
      boxsum_kernel<kExact><<<grid, kBoxsumThreads, 0, s>>>(*p);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
