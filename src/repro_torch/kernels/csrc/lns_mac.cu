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
//                         lns_boxsum_pallas (:69), up to kMaxGroups
//                         row sets (the data-parallel combine's
//                         parameters) in one launch.
//
// What bounds it on an H100: there is no multiply, so no tensor core can
// help.  The steps of one output element form a serial chain of ⊞: the
// contraction is walked in ascending order because ⊞ is only
// approximately associative and that order is the semantics.  Every form
// below gives each output element one thread that walks its contraction
// serially (no split-K, no tree, no atomics).  The ⊞-MAC has two forms,
// chosen by the launcher from the steps per segment CT alone, against
// kShortSteps (no argument, spec key or environment variable picks them):
//   * CT > kShortSteps: mac_kernel, the tiled form, for the forward at
//     K = 784 and K = 100 and every contraction over a batch of 500.  At
//     batch 5 its grid is a handful of warps and the time is the latency
//     of one ⊞ step's dependent path times the contraction length, plus
//     the launch (the chain); at batch 500 it is int32 instruction
//     throughput;
//   * CT <= kShortSteps: mac_short_kernel, the short form, for the
//     contractions over the batch of 5 (dW, dW-update, the segment
//     partials at CT = 1) and the dX (CT = 10).  There are a few steps and
//     many outputs: the time is the launch plus the latency of one round
//     trip to device memory plus a short chain, and at batch 500 (were it
//     taken) the bytes.  It maps one thread to each output of the
//     flattened (segment, row, column) index, columns fastest, so that no
//     lane idles on a narrow output and the segments are more outputs, not
//     more blocks; each thread issues all its operand, weight, momentum
//     and bias loads before it waits on any, and the block copies the Δ
//     table to shared memory behind its one barrier only after that (no
//     operand staging, no tile).
// The elementwise ⊞-SGD (update_kernel) is bound the same way as the short
// form: launch plus one round trip at the bias's 10 and 100 elements,
// bytes at the segmented step's 78400; its loads go first, one element a
// thread, then the table copy and barrier, and its block size follows n.
// So is the ⊞-reduce (boxsum_kernel), one row a thread: the combine's
// four parameters are one launch (row sets found from a flat row index),
// and a row's first steps are loaded before the table and then folded
// with mac_step.
// The tiled form's design:
//   * every (row, 32 columns) tile is one warp, WARPS warps a block (the
//     rows per block: 1, 2, 4 or 8, MacParams::rows; 4 unless the caller
//     picks another), so that at batch 5 each live warp has an SM
//     sub-partition of its own.  The rows per block are the one launch
//     parameter the block autotuner (kernels/autotune.py, blocks=auto) or
//     an explicit blocks=MxNxK may pick, and they change no order: each
//     output is still one thread walking its contraction in ascending
//     order; the rows per block only say which warps share a block's
//     staged B tile and its Δ table copy;
//   * keeps only the ⊞ on the accumulator's dependent path (mac_step):
//     the Δ index is a shift or a multiply-high by constants the host
//     works out (no divide), the Δ table is one __shared__ array of
//     (Δ+, Δ−) pairs with a zero pair past its end (no branch: the sign
//     relation is an address offset, "past the table" a clamp), and every
//     format and engine constant is read once, before the loop;
//   * stages tiles of 32 steps of both operands in shared memory, two
//     buffers: while the warps walk one tile, the next tile's global loads
//     are in flight, and each step's product is taken two steps before
//     the ⊞ that needs it (one compare finds a zero product: zero codes
//     are staged far below every code); transposed operands are read
//     through strides (no transpose is materialised) and ragged edges
//     read as the zero code, the ⊞ identity;
//   * both forms apply the epilogue (bias ⊞ / llReLU / requantize, or the
//     ⊞-SGD update) to the accumulator in registers, through one flush
//     function, so neither the pre-activation nor the weight gradient is
//     ever stored.
//
// Every device function below mirrors a function of the Pallas source;
// mac_step is _boxplus_codes (lns_matmul.py:93) rearranged for a product
// that is known ahead (see its comment).  The Python wrappers
// (kernels/lns_matmul/*.py) hold the plain PyTorch versions the kernels
// are checked against bit for bit.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// into a shared library with a plain C interface (see kernels/build.py).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The tiled form's output rows per block (one warp each) are its template
// parameter WARPS, one of 1, 2, 4, 8 (MacParams::rows).
constexpr int kTileC = 32;    // output columns per block (one warp)
constexpr int kTileK = 32;    // contraction steps staged and unrolled at once
constexpr int kAhead = 2;     // steps a product is taken before its ⊞
constexpr int kMaxTab = 1024;
// The short form takes a launch of at most kShortSteps steps a segment,
// set by measurement (scripts/ab_fused_step.py, the plain dW at batches
// 8-32; PERF.md): the short form is faster than the tiled one at 12
// steps and even with it at 16.
constexpr int kShortSteps = 12;
constexpr int kShortThreads = 128;
constexpr int kUpdateThreads = 128;  // at most, a block of the ⊞-SGD
constexpr int kBoxsumThreads = 128;  // at most, a block of the ⊞-reduce
// Steps of a row the ⊞-reduce loads before the table: the combine's 5
// segments at the paper's batch; 4 and 8 measured slower (PERF.md).
constexpr int kBoxsumSteps = 5;
// Row sets a ⊞-reduce launch takes: the combine's parameters of one layer
// arithmetic (w1, b1, w2, b2 under the default plan).
constexpr int kMaxGroups = 8;

// kLutMul is the LUT whose step is not a power of two: the launchers pick
// it from the index constants; the host passes kLut for both.
enum DeltaKind : int { kLut = 0, kBitshift = 1, kExact = 2, kLutMul = 3 };
// kEpiAny: the epilogue is read from the launch's parameters.
enum Epilogue : int { kEpiNone = 0, kEpiFwd = 1, kEpiUpdate = 2,
                      kEpiAny = 3 };

}  // namespace

// Parameter blocks shared with ctypes (kernels/build.py).  Every field is
// 8 bytes wide, so the layout has no padding and the Python mirror is a
// plain list of c_int64 / c_void_p fields in the same order.
struct LnsArgs {
  int64_t qf, code_max, min_nz, zero_code;
  int64_t delta_kind, n_tab, underflow;
  // The LUT index of a difference d >= 0, (d + r/2) // r for the table
  // step r (kernels/_common.py: lut_index_args):
  //   x = min(d + idx_half, idx_lim);  idx = x >> idx_shift, or
  //   idx = __umulhi(x, idx_mul) >> idx_shift where idx_mul != 0.
  // idx_lim = n_tab * r, so that every d past the table lands on n_tab.
  int64_t idx_half, idx_lim, idx_mul, idx_shift;
  // n_tab + 1 (Δ+, Δ−) pairs: Δ−(0) is the underflow sentinel and the
  // last pair is (0, 0), the Δ past the table.
  const int32_t* tab;
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
  // Output rows per block of the tiled form (1, 2, 4 or 8); the short form
  // does not read it.
  int64_t rows;
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

// One row set of a ⊞-reduce launch, `rows` rows of `steps` elements: row
// i's step s is at code[i * row_stride + s * step_stride] (likewise sign),
// its result at out_code[i] / out_sign[i].  `first` is the set's first row
// in the launch's flat row index, set by the launcher.
struct BoxsumSet {
  const int32_t* code;
  const int8_t* sign;
  int64_t rows, steps, row_stride, step_stride, first;
  int32_t* out_code;
  int8_t* out_sign;
};

// The ⊞-reduce of n_sets row sets in one launch, under one format and Δ
// engine; max_steps is set by the launcher.
struct BoxsumParams {
  LnsArgs lns;
  int64_t n_sets, max_steps;
  BoxsumSet sets[kMaxGroups];
};

static_assert(sizeof(LnsArgs) == 12 * 8, "LnsArgs layout");
static_assert(sizeof(SgdArgs) == 5 * 8, "SgdArgs layout");
static_assert(sizeof(BoxsumSet) == 9 * 8, "BoxsumSet layout");

namespace {

// The Δ table of the launch, copied once per block by every kernel that
// takes a LUT: (Δ+, Δ−) of entry i at bytes 8i and 8i + 4.
__shared__ int2 s_tab[kMaxTab + 1];

// The format and Δ engine of one launch, in registers; ``tab`` is the
// shared-memory address of s_tab.
struct Lns {
  int qf, code_max, min_nz, zero, underflow;
  int half, lim, shift;
  unsigned mul, tab;
  float scale;
};

__device__ __forceinline__ Lns make_lns(const LnsArgs& a) {
  Lns k;
  k.qf = (int)a.qf;
  k.code_max = (int)a.code_max;
  k.min_nz = (int)a.min_nz;
  k.zero = (int)a.zero_code;
  k.underflow = (int)a.underflow;
  k.half = (int)a.idx_half;
  k.lim = (int)a.idx_lim;
  k.shift = (int)a.idx_shift;
  k.mul = (unsigned)a.idx_mul;
  k.tab = (unsigned)__cvta_generic_to_shared(s_tab);
  k.scale = (float)(1 << a.qf);
  return k;
}

// Shared-memory access by 32-bit shared address.  volatile keeps each
// access on its side of the barriers around it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int lds(unsigned addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int2 lds2(unsigned addr) {
  int2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts2(unsigned addr, int2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(addr), "r"(v.x),
               "r"(v.y));
}

// The constants of mac_step, passed through shared memory so that the
// loop holds them in registers: ptxas rematerialises a loop-invariant
// kernel parameter inside the loop (an LDC, or the table's address
// rebuilt from SR_CgaCtaId), but cannot reload a value read from shared
// memory, which the loop writes.
constexpr int kPinned = 8;

__device__ __forceinline__ void pin_store(const Lns& k, int* s) {
  s[0] = k.code_max;
  s[1] = k.min_nz;
  s[2] = k.zero;
  s[3] = k.half;
  s[4] = k.lim;
  s[5] = k.shift;
  s[6] = (int)k.mul;
  s[7] = (int)k.tab;
}

__device__ __forceinline__ void pin_load(Lns& k, const int* s) {
  k.code_max = s[0];
  k.min_nz = s[1];
  k.zero = s[2];
  k.half = s[3];
  k.lim = s[4];
  k.shift = s[5];
  k.mul = (unsigned)s[6];
  k.tab = (unsigned)s[7];
}

__host__ __device__ constexpr bool is_lut(int kind) {
  return kind == kLut || kind == kLutMul;
}

// Copies the launch's table into s_tab; the caller synchronises.
template <int KIND>
__device__ __forceinline__ void load_table(const LnsArgs& a, int tid,
                                           int nthreads) {
  if (!is_lut(KIND)) return;
  const int2* tab = reinterpret_cast<const int2*>(a.tab);
  for (int i = tid; i <= (int)a.n_tab; i += nthreads) s_tab[i] = tab[i];
}

// _delta_from_tables (lns_matmul.py:60): nearest-sample LUT, Δ := 0 past
// the table, Δ-(0) = underflow sentinel.  d >= 0; opp4 is 0 for operands
// of the same sign and 4 (the byte offset of Δ−) for opposite signs.
template <int KIND>
__device__ __forceinline__ int delta_lut(int d, int opp4, const Lns& k) {
  const unsigned x = (unsigned)min(d + k.half, k.lim);
  const unsigned idx =
      KIND == kLutMul ? __umulhi(x, k.mul) >> k.shift : x >> k.shift;
  return lds(k.tab + (idx << 3) + opp4);
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
__device__ __forceinline__ int delta(int d, int opp4, const Lns& k) {
  if (is_lut(KIND)) return delta_lut<KIND>(d, opp4, k);
  if (KIND == kBitshift) return delta_bitshift(d, opp4 == 0, k);
  return delta_exact(d, opp4 == 0, k);
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
  int code = min(m + delta<KIND>(d, same ? 0 : 4, k), k.code_max);
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

// An operand's zero code as it is staged for the chain: far enough below
// every code that its sum with any staged code is below min_nz, so that
// the product's one test (stage_product) finds it.
__device__ __forceinline__ int staged_zero(const Lns& k) {
  return k.zero - (1 << 25);
}

// Where a zero product enters the MAC chain: far enough below every code
// that its difference from any accumulator indexes past the Δ table (the
// host keeps idx_lim below 2^30) and gives Δ = 0 for the bit-shift and
// exact engines.
__device__ __forceinline__ int zero_product(const Lns& k) {
  return k.zero - (1 << 30);
}

// The product step of _mac_kernel (lns_matmul.py:330-335) on two staged
// operands (code with staged_zero() for the zero code, sign · 4): the
// code, or zero_product() where the reference gives the zero code (an
// operand is zero, or the sum underflows); the sign · 4.
__device__ __forceinline__ void stage_product(int2 a, int2 b, const Lns& k,
                                              int& pc, int& ps4) {
  const int sum = min(a.x + b.x, k.code_max);
  pc = sum < k.min_nz ? zero_product(k) : sum;
  ps4 = a.y ^ b.y;
}

// One ⊞ of a product (pc, ps4) from stage_product() into the accumulator
// (acc, acc_s4): _boxplus_codes with its cases folded into the data.
//   * A zero product is zero_product(): Δ = 0 and max() keep the
//     accumulator, and acc > pc keeps its sign.
//   * An exact cancellation (opposite signs, d = 0) reads Δ−(0), the
//     underflow sentinel, and flushes through the max() below.
//   * code < min_nz → zero is max(code, zero): zero = min_nz − 1.
//   * A zero accumulator takes the product: m = max(acc, pc) is pc, and
//     acc > pc fails, so the sign is the product's.
//   * With equal signs either sign is the result's, so the sign is one
//     compare.  The sign of a zero accumulator is not kept at 0 on the
//     chain (no step reads it: a zero accumulator takes the product's);
//     the flush clears it.
// On the dependent path: sub, abs, add-min, shift (or mul-hi, shift),
// shift-add, LDS, add-min, max, select.
template <int KIND>
__device__ __forceinline__ void mac_step(int& acc, int& acc_s4, int pc,
                                         int ps4, const Lns& k) {
  const int m = max(acc, pc);
  const int dl = delta<KIND>(abs(acc - pc), acc_s4 ^ ps4, k);
  const int v = max(min(m + dl, k.code_max), k.zero);
  acc_s4 = acc > pc ? acc_s4 : ps4;
  acc = acc == k.zero ? m : v;
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

// The (R, C) data an epilogue reads beside the accumulator at output
// o_at, column c: the bias (forward), or W and M (update).
struct Resident {
  int bias_c, bias_s;
  int wc, ws, mc, ms;
};

template <int EPI>
__device__ __forceinline__ Resident load_resident(const MacParams& p,
                                                  int64_t o_at, int64_t c) {
  const int epi = EPI == kEpiAny ? (int)p.epilogue : EPI;
  Resident v{0, 0, 0, 0, 0, 0};
  if (epi == kEpiFwd) {
    if (p.bias_code != nullptr) {
      v.bias_c = __ldg(p.bias_code + c);
      v.bias_s = __ldg(p.bias_sign + c);
    }
  } else if (epi == kEpiUpdate) {
    v.wc = __ldg(p.w_code + o_at);
    v.ws = __ldg(p.w_sign + o_at);
    if (p.sgd.mom_on) {
      v.mc = __ldg(p.m_code + o_at);
      v.ms = __ldg(p.m_sign + o_at);
    }
  }
  return v;
}

// The flush of _mac_kernel (lns_matmul.py:300-318) for both forms: the
// accumulator's sign cleared where it is zero, the epilogue EPI (or the
// launch's, for kEpiAny), the stores at o_at.
template <int KIND, int EPI>
__device__ __forceinline__ void flush(const MacParams& p, const Lns& k,
                                      int64_t o_at, int acc, int acc_s4,
                                      const Resident& res) {
  const int epi = EPI == kEpiAny ? (int)p.epilogue : EPI;
  int code = acc;
  int sign = code == k.zero ? 0 : acc_s4 >> 2;
  if (epi == kEpiFwd) {
    // _apply_fwd_epilogue (lns_matmul.py:165): bias ⊞ → llReLU →
    // requantize; z_sign is the post-bias sign.
    if (p.bias_code != nullptr)
      boxplus<KIND>(code, sign, res.bias_c, res.bias_s, k, code, sign);
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
    if (p.z_sign_out != nullptr) p.z_sign_out[o_at] = (int8_t)z_sign;
  } else if (epi == kEpiUpdate) {
    int wc = res.wc, ws = res.ws, mc = res.mc, ms = res.ms;
    sgd_update<KIND>(wc, ws, mc, ms, code, sign, p.sgd, k);
    code = wc;
    sign = ws;
    if (p.sgd.mom_on) {
      p.m_code_out[o_at] = mc;
      p.m_sign_out[o_at] = (int8_t)ms;
    }
  }
  p.out_code[o_at] = code;
  p.out_sign[o_at] = (int8_t)sign;
}

// _mac_kernel (lns_matmul.py:236) with the epilogues of :165 and :214, and
// its partial flush (:300, :343): grid z walks contraction segment z alone
// into its own output slot.  Grid x holds the row tiles times the column
// tiles, columns fastest (grid y would cap the rows at 65535 tiles): warp
// w of block (x, 0, z), with x = y' * ceil(C / kTileC) + x', holds output
// row y' * WARPS + w, lane l column x' * kTileC + l.
//
// The block stages tiles of kTileK steps of A's WARPS rows and B's kTileC
// columns in two shared buffers: while the warps walk one tile, each
// thread holds its share of the next tile in registers (one A element and
// kTileK / WARPS B elements), loaded from global memory before the walk
// and stored to the other buffer after it; one barrier a tile.  Static
// shared memory: s_a 512 · WARPS bytes, s_b 16 896, s_pin 32 and s_tab
// 8 200, 29 224 bytes at WARPS = 8, under the 48 KiB of a block.
template <int KIND, int WARPS>
__global__ void __launch_bounds__(WARPS * kTileC)
    mac_kernel(const MacParams p) {
  constexpr int kThreads = WARPS * kTileC;
  constexpr int kStageB = kTileK * kTileC / kThreads;  // B elements a thread
  __shared__ int2 s_a[2][WARPS][kTileK];
  __shared__ int2 s_b[2][kTileK][kTileC + 1];
  __shared__ int s_pin[kPinned];
  const int tid = threadIdx.x;
  const int w = tid / kTileC, lane = tid % kTileC;
  load_table<KIND>(p.lns, tid, kThreads);
  Lns k = make_lns(p.lns);
  if (tid == 0) pin_store(k, s_pin);
  const unsigned col_tiles = (unsigned)((p.C + kTileC - 1) / kTileC);
  const int64_t r0 = (int64_t)(blockIdx.x / col_tiles) * WARPS;
  const int64_t c0 = (int64_t)(blockIdx.x % col_tiles) * kTileC;
  const int64_t t_lo = (int64_t)blockIdx.z * p.CT;
  const int ct = (int)p.CT;

  // This thread's share of a tile, the operands' unit-stride axis fastest
  // across the threads: A's element (a_lr, a_lt) and B's elements (lt, lc)
  // for q < kStageB.  An element is read where its step is below the steps
  // left; a row or column past the edge gets a step that never is
  // (INT_MAX), and reads as the zero code, the ⊞ identity.
  const bool a_tfast = p.a_st == 1;
  const int a_lt = a_tfast ? tid % kTileK : tid / WARPS;
  const int a_lr = a_tfast ? tid / kTileK : tid % WARPS;
  const int a_at = r0 + a_lr < p.R ? a_lt : INT_MAX;
  const unsigned a_sx = (a_lr * kTileK + a_lt) * 8;
  const bool b_cfast = p.b_st != 1;
  int b_at[kStageB], b_off[kStageB];
  unsigned b_sx[kStageB];
#pragma unroll
  for (int q = 0; q < kStageB; ++q) {
    const int e = tid + q * kThreads;
    const int lt = b_cfast ? e / kTileC : e % kTileK;
    const int lc = b_cfast ? e % kTileC : e / kTileK;
    b_at[q] = c0 + lc < p.C ? lt : INT_MAX;
    b_off[q] = lt * (int)p.b_st + lc * (int)p.b_sc;
    b_sx[q] = (lt * (kTileC + 1) + lc) * 8;
  }
  // Loop-carried, so that they stay in registers: the operands at the next
  // tile to fetch, and the shared addresses of the buffer being filled and
  // of the one being read.
  const int64_t a_org = (r0 + a_lr) * p.a_sr + (t_lo + a_lt) * p.a_st;
  const int64_t b_org = t_lo * p.b_st + c0 * p.b_sc;
  const int32_t* a_code = p.a_code + a_org;
  const int8_t* a_sign = p.a_sign + a_org;
  const int32_t* b_code = p.b_code + b_org;
  const int8_t* b_sign = p.b_sign + b_org;
  const int64_t a_tile = kTileK * p.a_st, b_tile = kTileK * p.b_st;
  unsigned fill_a = smem_addr(s_a[0]), fill_b = smem_addr(s_b[0]);
  unsigned read_a = smem_addr(s_a[1]), read_b = smem_addr(s_b[1]);
  // This thread's operands of step i in a buffer: A's row w, B's column.
  const unsigned ra = w * kTileK * 8, rb = lane * 8;
  constexpr unsigned kRowB = (kTileC + 1) * 8;

  int ac, as, bc[kStageB], bs[kStageB];
  // Loads the thread's share of the tile `left` steps before the end, and
  // moves the operands on by a tile.
  auto fetch = [&](int left) {
    ac = a_at < left ? __ldg(a_code) : k.zero;
    as = a_at < left ? (int)__ldg(a_sign) : 0;
#pragma unroll
    for (int q = 0; q < kStageB; ++q) {
      bc[q] = b_at[q] < left ? __ldg(b_code + b_off[q]) : k.zero;
      bs[q] = b_at[q] < left ? (int)__ldg(b_sign + b_off[q]) : 0;
    }
    a_code += a_tile;
    a_sign += a_tile;
    b_code += b_tile;
    b_sign += b_tile;
  };
  // Stores it to the buffer being filled as stage_product takes it.
  auto store = [&]() {
    sts2(fill_a + a_sx,
         make_int2(ac == k.zero ? staged_zero(k) : ac, as << 2));
#pragma unroll
    for (int q = 0; q < kStageB; ++q)
      sts2(fill_b + b_sx[q],
           make_int2(bc[q] == k.zero ? staged_zero(k) : bc[q], bs[q] << 2));
  };
  auto swap_buffers = [&]() {
    const unsigned ta = fill_a, tb = fill_b;
    fill_a = read_a;
    fill_b = read_b;
    read_a = ta;
    read_b = tb;
  };

  // The product of step i of the tile in the read buffer.
  auto product = [&](int i, int& pc, int& ps4) {
    stage_product(lds2(read_a + ra + i * 8), lds2(read_b + rb + i * kRowB),
                  k, pc, ps4);
  };

  fetch(ct);
  store();
  __syncthreads();
  pin_load(k, s_pin);
  swap_buffers();
  int acc = k.zero, acc_s4 = 0;
  // Whole tiles: the chain of kTileK steps unrolled, each step's product
  // taken kAhead steps before the ⊞ that needs it, the next tile in
  // flight.
  const int t_main = ct - ct % kTileK;
  for (int t = 0; t < t_main; t += kTileK) {
    fetch(ct - t - kTileK);
    int pc[kTileK], ps4[kTileK];
#pragma unroll
    for (int i = 0; i < kTileK + kAhead; ++i) {
      if (i < kTileK) product(i, pc[i], ps4[i]);
      if (i >= kAhead)
        mac_step<KIND>(acc, acc_s4, pc[i - kAhead], ps4[i - kAhead], k);
    }
    store();
    __syncthreads();
    swap_buffers();
  }
  // The last CT % kTileK steps, staged by the last fetch.
  for (int i = 0; i < ct - t_main; ++i) {
    int pc, ps4;
    product(i, pc, ps4);
    mac_step<KIND>(acc, acc_s4, pc, ps4, k);
  }

  const int64_t r = r0 + w, c = c0 + lane;
  if (r >= p.R || c >= p.C) return;
  const int64_t o_at = (int64_t)blockIdx.z * p.R * p.C + r * p.C + c;
  flush<KIND, kEpiAny>(p, k, o_at, acc, acc_s4,
                       load_resident<kEpiAny>(p, o_at, c));
}

// The product step of _mac_kernel (lns_matmul.py:330-335) on two operands
// as they are stored: the code, or zero_product() where the reference
// gives the zero code (an operand is zero, or the sum underflows); the
// sign · 4.
__device__ __forceinline__ void raw_product(int ac, int as, int bc, int bs,
                                            const Lns& k, int& pc,
                                            int& ps4) {
  const int sum = min(ac + bc, k.code_max);
  pc = ac == k.zero || bc == k.zero || sum < k.min_nz ? zero_product(k)
                                                      : sum;
  ps4 = (as ^ bs) << 2;
}

// _mac_kernel (lns_matmul.py:236) in the short form, for CT <= kShortSteps
// steps a segment: thread o holds output o of the flattened (segment z,
// row r, column c) index, columns fastest, which is also where the output
// is stored.  The thread issues the loads of its CT steps of A and B and
// of the epilogue's resident data (bias, or W and M) straight from device
// memory into registers; only then does the block copy the Δ table to
// shared memory and meet its one barrier, and only where a Δ is read (a
// LUT, and a second step or an epilogue).  It forms every product and
// walks the chain serially in ascending order, with the same mac_step as
// the tiled form.  The first step needs no Δ: a zero accumulator takes the
// product (mac_step's case), or stays zero with sign 0 when the product
// is zero.  Every step's work sits behind a uniform test of CT, so a
// launch of 1 or 5 steps costs no more than its steps; one instantiation
// per epilogue keeps each kernel's code to the one flush it runs.
template <int KIND, int EPI>
__global__ void __launch_bounds__(kShortThreads)
    mac_short_kernel(const MacParams p) {
  // A thread past the outputs reads output 0's operands and leaves after
  // the barrier.
  const unsigned at = blockIdx.x * kShortThreads + threadIdx.x;
  const bool live = (int64_t)at < p.S * p.R * p.C;
  const unsigned o = live ? at : 0;
  const unsigned cols = (unsigned)p.C, rows = (unsigned)p.R;
  const unsigned rz = o / cols, c = o - rz * cols;
  const unsigned z = rz / rows, r = rz - z * rows;
  const int ct = (int)p.CT;
  const int64_t t0 = (int64_t)z * ct;
  const int32_t* a_code = p.a_code + r * p.a_sr + t0 * p.a_st;
  const int8_t* a_sign = p.a_sign + r * p.a_sr + t0 * p.a_st;
  const int32_t* b_code = p.b_code + t0 * p.b_st + c * p.b_sc;
  const int8_t* b_sign = p.b_sign + t0 * p.b_st + c * p.b_sc;
  int ac[kShortSteps], as[kShortSteps], bc[kShortSteps], bs[kShortSteps];
#pragma unroll
  for (int i = 0; i < kShortSteps; ++i) {
    if (i >= ct) break;
    ac[i] = __ldg(a_code + i * p.a_st);
    as[i] = __ldg(a_sign + i * p.a_st);
    bc[i] = __ldg(b_code + i * p.b_st);
    bs[i] = __ldg(b_sign + i * p.b_st);
  }
  const Resident res = load_resident<EPI>(p, o, c);
  if (is_lut(KIND) && (ct > 1 || EPI != kEpiNone)) {
    load_table<KIND>(p.lns, threadIdx.x, kShortThreads);
    __syncthreads();
  }
  if (!live) return;
  const Lns k = make_lns(p.lns);
  int pc[kShortSteps], ps4[kShortSteps];
#pragma unroll
  for (int i = 0; i < kShortSteps; ++i) {
    if (i >= ct) break;
    raw_product(ac[i], as[i], bc[i], bs[i], k, pc[i], ps4[i]);
  }
  int acc = k.zero, acc_s4 = 0;
  if (ct > 0) {
    acc = max(pc[0], k.zero);
    acc_s4 = pc[0] > k.zero ? ps4[0] : 0;
  }
#pragma unroll
  for (int i = 1; i < kShortSteps; ++i) {
    if (i >= ct) break;
    mac_step<KIND>(acc, acc_s4, pc[i], ps4[i], k);
  }
  flush<KIND, EPI>(p, k, o, acc, acc_s4, res);
}

// _update_kernel (update.py:35): the ⊞-SGD, one element a thread.  The
// thread issues its loads of W, G (and M) first; then the block copies a
// LUT to shared memory and meets its one barrier.  The launcher sizes the
// block to n.
template <int KIND>
__global__ void __launch_bounds__(kUpdateThreads)
    update_kernel(const UpdateParams p) {
  // A thread past n reads element 0 and leaves after the barrier.
  const int64_t at = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = at < p.n;
  const int64_t i = live ? at : 0;
  int wc = __ldg(p.w_code + i), ws = __ldg(p.w_sign + i);
  const int gc = __ldg(p.g_code + i), gs = __ldg(p.g_sign + i);
  int mc = 0, ms = 0;
  if (p.sgd.mom_on) {
    mc = __ldg(p.m_code + i);
    ms = __ldg(p.m_sign + i);
  }
  if (is_lut(KIND)) {
    load_table<KIND>(p.lns, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  if (!live) return;
  const Lns k = make_lns(p.lns);
  sgd_update<KIND>(wc, ws, mc, ms, gc, gs, p.sgd, k);
  p.w_code_out[i] = wc;
  p.w_sign_out[i] = (int8_t)ws;
  if (p.sgd.mom_on) {
    p.m_code_out[i] = mc;
    p.m_sign_out[i] = (int8_t)ms;
  }
}

// The launch floor: a kernel that does nothing, timed beside the others.
__global__ void empty_kernel() {}

// _kernel (lns_boxsum.py:28): one thread per row folds the row's steps
// in ascending order into one accumulator.  Every element is read once
// and a row's steps are a serial chain of ⊞, so at the data-parallel
// combine's shapes (79510 rows of 5 steps over w1, b1, w2 and b2: 2.4 MB
// and 12 M operations, under a microsecond either way) the time is the
// launch, the round trips to memory and the instructions each thread
// issues.  The design:
//   * one launch for up to kMaxGroups row sets: thread `at` of the flat
//     row index folds row at − first of the last set whose first row is
//     at or before it (uniform within a block but at the sets' bounds);
//     an instantiation per set count (1, 2, 4, 8), so that a thread pays
//     only for the sets its launch has;
//   * rows and steps are read through strides: the combine passes its
//     (S, E) partials in place, where a warp's 32 rows are 32 neighbouring
//     words at every step;
//   * the thread issues the loads of its row's first kBoxsumSteps steps
//     before the block copies a LUT to shared memory and meets its one
//     barrier (only where a Δ is read: a set of more than one step), so
//     that the table's round trip and the row's overlap; further steps
//     are loaded in a plain loop, which the compiler unrolls;
//   * the chain is mac_step's folded ⊞, an element of the zero code
//     entering as zero_product(); the first step is peeled: a zero
//     accumulator takes the element, or stays the zero code with sign 0.
template <int KIND, int NSETS>
__global__ void __launch_bounds__(kBoxsumThreads)
    boxsum_kernel(const BoxsumParams p) {
  const int at = blockIdx.x * blockDim.x + threadIdx.x;
  // The thread's set among the first NSETS, by selects over constant
  // indices: an index into the parameter block held in a register costs a
  // round trip to memory.  The launcher gives the sets past n_sets no rows.
  BoxsumSet set = p.sets[0];
#pragma unroll
  for (int j = 1; j < NSETS; ++j)
    if (at >= p.sets[j].first) set = p.sets[j];
  // A thread past the last row loads nothing and leaves after the barrier.
  const int i = at - (int)set.first;
  const bool live = i < set.rows;
  const int steps = live ? (int)set.steps : 0;
  const int32_t* code = set.code + (int64_t)i * set.row_stride;
  const int8_t* sign = set.sign + (int64_t)i * set.row_stride;
  const int64_t step_stride = set.step_stride;
  int c[kBoxsumSteps], s4[kBoxsumSteps];
#pragma unroll
  for (int j = 0; j < kBoxsumSteps; ++j) {
    c[j] = j < steps ? __ldg(code + j * step_stride) : 0;
    s4[j] = j < steps ? (int)__ldg(sign + j * step_stride) << 2 : 0;
  }
  if (is_lut(KIND) && p.max_steps > 1) {
    load_table<KIND>(p.lns, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  if (!live) return;
  const Lns k = make_lns(p.lns);
  int acc = k.zero, acc_s4 = 0;
  if (steps > 0) {
    acc = c[0];
    acc_s4 = c[0] == k.zero ? 0 : s4[0];
  }
#pragma unroll
  for (int j = 1; j < kBoxsumSteps; ++j)
    if (j < steps)
      mac_step<KIND>(acc, acc_s4, c[j] == k.zero ? zero_product(k) : c[j],
                     s4[j], k);
  for (int t = kBoxsumSteps; t < steps; ++t) {
    const int ct = __ldg(code + t * step_stride);
    mac_step<KIND>(acc, acc_s4, ct == k.zero ? zero_product(k) : ct,
                   (int)__ldg(sign + t * step_stride) << 2, k);
  }
  set.out_code[i] = acc;
  set.out_sign[i] = (int8_t)(acc == k.zero ? 0 : acc_s4 >> 2);
}

// The kernel instantiation a launch takes, or -1 for arguments the kernels
// do not take: a LUT of 1 to kMaxTab entries, and zero = min_nz − 1 (the
// flush of mac_step).
int launch_kind(const LnsArgs& a) {
  if (a.zero_code != a.min_nz - 1) return -1;
  switch (a.delta_kind) {
    case kLut:
      if (a.n_tab < 1 || a.n_tab > kMaxTab || a.tab == nullptr) return -1;
      return a.idx_mul != 0 ? kLutMul : kLut;
    case kBitshift:
    case kExact:
      return (int)a.delta_kind;
    default:
      return -1;
  }
}

// The ⊞-reduce's instantiation for the Δ kind, holding NSETS row sets.
template <int NSETS>
int launch_boxsum(int kind, dim3 grid, int block, cudaStream_t stream,
                  const BoxsumParams& p) {
  switch (kind) {
    case kLut: boxsum_kernel<kLut, NSETS><<<grid, block, 0, stream>>>(p); break;
    case kLutMul:
      boxsum_kernel<kLutMul, NSETS><<<grid, block, 0, stream>>>(p);
      break;
    case kBitshift:
      boxsum_kernel<kBitshift, NSETS><<<grid, block, 0, stream>>>(p);
      break;
    case kExact:
      boxsum_kernel<kExact, NSETS><<<grid, block, 0, stream>>>(p);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The tiled form's instantiation for the Δ kind, WARPS rows a block.
template <int WARPS>
int launch_tiled(int kind, dim3 grid, cudaStream_t stream,
                 const MacParams& p) {
  constexpr int threads = WARPS * kTileC;
  switch (kind) {
    case kLut: mac_kernel<kLut, WARPS><<<grid, threads, 0, stream>>>(p); break;
    case kLutMul:
      mac_kernel<kLutMul, WARPS><<<grid, threads, 0, stream>>>(p);
      break;
    case kBitshift:
      mac_kernel<kBitshift, WARPS><<<grid, threads, 0, stream>>>(p);
      break;
    case kExact:
      mac_kernel<kExact, WARPS><<<grid, threads, 0, stream>>>(p);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The short form's instantiation for the launch's epilogue.
template <int KIND>
int launch_short(dim3 grid, cudaStream_t stream, const MacParams& p) {
  switch (p.epilogue) {
    case kEpiNone:
      mac_short_kernel<KIND, kEpiNone><<<grid, kShortThreads, 0, stream>>>(p);
      return 0;
    case kEpiFwd:
      mac_short_kernel<KIND, kEpiFwd><<<grid, kShortThreads, 0, stream>>>(p);
      return 0;
    case kEpiUpdate:
      mac_short_kernel<KIND, kEpiUpdate>
          <<<grid, kShortThreads, 0, stream>>>(p);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define LNS_DISPATCH(KERNEL, KIND, GRID, THREADS, STREAM, P)               \
  switch (KIND) {                                                          \
    case kLut: KERNEL<kLut><<<GRID, THREADS, 0, STREAM>>>(P); break;       \
    case kLutMul: KERNEL<kLutMul><<<GRID, THREADS, 0, STREAM>>>(P); break; \
    case kBitshift:                                                        \
      KERNEL<kBitshift><<<GRID, THREADS, 0, STREAM>>>(P);                  \
      break;                                                               \
    case kExact: KERNEL<kExact><<<GRID, THREADS, 0, STREAM>>>(P); break;   \
    default: return (int)cudaErrorInvalidValue;                            \
  }

extern "C" {

int lns_mac_params_size() { return (int)sizeof(MacParams); }
int lns_update_params_size() { return (int)sizeof(UpdateParams); }
int lns_boxsum_params_size() { return (int)sizeof(BoxsumParams); }
int lns_boxsum_max_sets() { return kMaxGroups; }
int lns_max_table() { return kMaxTab; }
int lns_short_steps() { return kShortSteps; }
const char* lns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues one ⊞-MAC launch on ``stream``; returns cudaGetLastError().
// The form is chosen by the steps a segment alone: the short form at CT
// <= kShortSteps, the tiled form above, with p->rows (1, 2, 4 or 8; any
// other value is refused) output rows a block.
int lns_mac_launch(const MacParams* p, void* stream) {
  // Segments take no epilogue; the grid z extent holds at most 65535; a
  // tile's offsets and the steps are int32; the short form's flattened
  // output index is int32; the tiled form's row tiles times column tiles
  // fit grid x.
  if (p->S < 1 || p->S > 65535 || (p->S > 1 && p->epilogue != kEpiNone) ||
      p->CT < 0 || p->CT >= INT_MAX - kTileK || p->a_st < 0 ||
      p->a_st >= (1 << 26) || p->b_st < 0 || p->b_st >= (1 << 26) ||
      p->b_sc < 0 || p->b_sc >= (1 << 26) || p->R < 1 || p->C < 1)
    return (int)cudaErrorInvalidValue;
  const int kind = launch_kind(p->lns);
  if (p->CT <= kShortSteps) {
    const int64_t n = p->S * p->R * p->C;
    if (n > INT_MAX) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((n + kShortThreads - 1) / kShortThreads));
    const cudaStream_t st = (cudaStream_t)stream;
    int rc;
    switch (kind) {
      case kLut: rc = launch_short<kLut>(grid, st, *p); break;
      case kLutMul: rc = launch_short<kLutMul>(grid, st, *p); break;
      case kBitshift: rc = launch_short<kBitshift>(grid, st, *p); break;
      case kExact: rc = launch_short<kExact>(grid, st, *p); break;
      default: rc = (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  } else {
    const int64_t rows = p->rows;
    if (rows != 1 && rows != 2 && rows != 4 && rows != 8)
      return (int)cudaErrorInvalidValue;
    const int64_t tiles = ((p->C + kTileC - 1) / kTileC) *
                          ((p->R + rows - 1) / rows);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)tiles, 1, (unsigned)p->S);
    const cudaStream_t st = (cudaStream_t)stream;
    int rc;
    switch (rows) {
      case 1: rc = launch_tiled<1>(kind, grid, st, *p); break;
      case 2: rc = launch_tiled<2>(kind, grid, st, *p); break;
      case 4: rc = launch_tiled<4>(kind, grid, st, *p); break;
      default: rc = launch_tiled<8>(kind, grid, st, *p); break;
    }
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

// Enqueues one elementwise ⊞-SGD launch; returns cudaGetLastError().  A
// block holds kUpdateThreads threads, or the whole warps that n needs
// where that is fewer.
int lns_update_launch(const UpdateParams* p, void* stream) {
  if (p->n < 1) return (int)cudaErrorInvalidValue;
  const int block =
      (int)(p->n < kUpdateThreads ? (p->n + 31) / 32 * 32 : kUpdateThreads);
  dim3 grid((unsigned)((p->n + block - 1) / block));
  LNS_DISPATCH(update_kernel, launch_kind(p->lns), grid, block,
               (cudaStream_t)stream, *p);
  return (int)cudaGetLastError();
}

// Enqueues the empty kernel, one warp; returns cudaGetLastError().
int lns_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Enqueues one ⊞-reduce launch of p->n_sets row sets; returns
// cudaGetLastError().  The sets' rows are numbered one after another in a
// flat int32 index; the instantiation holds the fewest of 1, 2, 4 or 8
// sets that take them.  A block holds kBoxsumThreads threads, or the
// whole warps that the rows need where that is fewer.
int lns_boxsum_launch(const BoxsumParams* p, void* stream) {
  if (p->n_sets < 1 || p->n_sets > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  BoxsumParams q = *p;
  int64_t n = 0;
  q.max_steps = 0;
  for (int j = 0; j < q.n_sets; ++j) {
    BoxsumSet& s = q.sets[j];
    if (s.rows < 1 || s.steps < 0 || s.steps > INT_MAX)
      return (int)cudaErrorInvalidValue;
    s.first = n;
    n += s.rows;
    if (n > INT_MAX - kBoxsumThreads) return (int)cudaErrorInvalidValue;
    q.max_steps = q.max_steps > s.steps ? q.max_steps : s.steps;
  }
  for (int j = (int)q.n_sets; j < kMaxGroups; ++j) {
    q.sets[j] = BoxsumSet{};
    q.sets[j].first = n;
  }
  const int block =
      (int)(n < kBoxsumThreads ? (n + 31) / 32 * 32 : kBoxsumThreads);
  dim3 grid((unsigned)((n + block - 1) / block));
  const int kind = launch_kind(q.lns);
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (q.n_sets == 1) rc = launch_boxsum<1>(kind, grid, block, st, q);
  else if (q.n_sets == 2) rc = launch_boxsum<2>(kind, grid, block, st, q);
  else if (q.n_sets <= 4) rc = launch_boxsum<4>(kind, grid, block, st, q);
  else rc = launch_boxsum<kMaxGroups>(kind, grid, block, st, q);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
