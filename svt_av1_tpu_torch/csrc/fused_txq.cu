// Fused DCT_DCT 16x16 forward transform + quantize + dequantize (sm_90a).
//
// Replaces the TPU kernel svt_av1_tpu/ops/pallas/fused_txq.py:_kernel
// (pl.pallas_call in _build, entered through fwd_txfm_quant_16x16_qp).
// It computes what that kernel computes, for a batch of B residual
// blocks:
//   y1[i][w] = sum_h fv[i][h] * x[h][w]          (vertical pass)
//   y2[i][j] = sum_w y1[i][w] * fh[j][w]          (horizontal pass)
//   coeff    = round_half_even(y2)                 (int32)
//   qcoeff, dqcoeff = quantize_b epilogue with the DC constants at
//   (0, 0) and the AC constants elsewhere.
//
// Three entry points share the arithmetic:
//   svt_fused_txq16     the kernel the encode runs (below), one set of
//                       quantizer constants for the whole batch;
//   svt_fused_txq16_rows the same kernel with a quantizer row per block:
//                       an (S, 10) table of packed constants and an int32
//                       row index per block (a batch of S independent
//                       streams, each at its own qindex; the reference
//                       reaches this form when jax.vmap batches the
//                       pallas_call over streams with a per-stream qparams
//                       row).  Each block reads its row's ten constants
//                       before its epilogue;
//   svt_fused_txq16_v1  the first, simple kernel (one thread per
//                       coefficient, 4 blocks per 1024-thread block),
//                       kept to hold the redesign bit-identical to it and
//                       to time both in one run; nothing in the encode
//                       calls it.
//
// Bound on the H100: per block 2 * 2 * 16^3 = 16 KFLOP of float32 work
// against 1 KB read and 3 KB written: 4 FLOP per byte, about 5x below
// the card's float32 ridge (67 TFLOP/s over 3.35 TB/s), so the kernel is
// bound by memory.  At the encode's batch (about 2,000 blocks, 2 MB in,
// 6 MB out, all of it in the 50 MB L2) what counts is how soon the bytes
// are in flight, how short each warp's chain of work is, and that the
// stores of one block overlap the work on the next.  The design:
//   * Persistent thread blocks of 64 threads, one 16x16 block at a time:
//     the grid is kMaxPerSm thread blocks per SM (fewer when the batch is
//     smaller), and each walks the batch with a stride of the grid.  A
//     few 16x16 blocks per thread block let one block's stores drain
//     while the next is computed; more, smaller thread blocks measured
//     slower at the encode's batch, as did 4 or 8 blocks per step.
//   * The residual arrives in shared memory by 1-D bulk asynchronous
//     copies (cp.async.bulk, completing on an mbarrier), kStages buffers
//     deep: the first copies are issued before anything else, and a
//     buffer is refilled as soon as pass 1 has read it, so the copy
//     overlaps pass 2 and the next block.  The two matrices come the same
//     way, once per thread block, already transposed by the caller.
//   * Each thread computes 4 outputs of a pass, so a warp's chain of work
//     is short.  Pass 1: a thread owns rows r..r+3 of one column of y1
//     and reads the column of x (16 words, four threads per word).  Pass 2:
//     a thread owns columns c..c+3 of one row.  y1 goes between the passes
//     through shared memory at a row stride of 20 words, which makes the
//     pass-1 writes (rows 4 apart: 16 banks apart) and the pass-2 row
//     reads (8 rows a warp: 8 distinct bank offsets) free of bank
//     conflicts.  Each step reads its four matrix entries as one 16-byte
//     load shared by the lanes of the warp (2 or 4 distinct addresses).
//     The ten quantizer constants are read once per thread block.  The
//     matrices are not read as FMA operands from constant memory (kernel
//     parameters): a form that did so was no faster than the first
//     kernel, likely because 512 distinct entries overflow the SM's small
//     constant cache.
//   * The outputs leave as 16-byte vector stores, 512 contiguous bytes a
//     warp, each lane's 4 coefficients of a row.
//   * A batch of any size runs without padding.
// No tensor cores: at 4 FLOP per byte they cannot help a memory-bound
// kernel; TF32 would round the matrix entries to a 10-bit mantissa,
// which moves coefficients in the thousands by whole units, far outside
// the rounding-tie rule; and 3xTF32 only adds work.
//
// Summation order: each output is one thread's sequential fused
// multiply-add chain, k = 0..15 in increasing order (__fmaf_rn, one
// rounding per step), in both passes and in both entry points, so the
// two kernels give bit-identical results.  It is a fixed order, but not
// the order of cuBLAS (the plain PyTorch version on the card) nor of
// XLA, so a coefficient whose exact value lies on a .5 rounding tie may
// differ by one from theirs; the quantizer then runs on this kernel's
// own coefficients.
//
// Rounding: rintf rounds half to even, like jnp.round and torch.round;
// roundf (half away from zero) would not match them.
//
// Integer safety: the quantizer runs in int32 in the reference's
// operation order.  |tmp| <= 32767 after the clip, |quant| <= 2^15 and
// quant_shift <= 2^14 (quantizer steps are >= 4), so tmp * quant and
// ((tmp * quant >> 16) + tmp) * quant_shift stay below 2^31 and never
// wrap; >> on a negative int is an arithmetic shift, as in the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;
constexpr int kCoeffs = kN * kN;
constexpr int kBlockBytes = kCoeffs * 4;
constexpr int kPad = 20;               // y1 row stride in shared memory
constexpr int kThreads = 64;           // per thread block: one 16x16 block
constexpr int kStages = 2;             // residual buffers in flight
constexpr int kMaxPerSm = 8;           // thread blocks per SM, at most

// Quantizer constants packed as [zbin, round, quant, quant_shift,
// dequant] x [DC, AC].
struct Quant {
  int zbin, rnd, quant, shift, deq;
};

__device__ __forceinline__ void quantize(int v, const Quant& k, int& qo,
                                         int& dqo) {
  const int a = v < 0 ? -v : v;
  int tmp = a + k.rnd;
  tmp = tmp < -32768 ? -32768 : (tmp > 32767 ? 32767 : tmp);
  int q = ((((tmp * k.quant) >> 16) + tmp) * k.shift) >> 16;
  if (a < k.zbin) q = 0;
  const int dq = q * k.deq;
  qo = v < 0 ? -q : q;
  dqo = v < 0 ? -dq : dq;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Adds to the barrier's expected transaction bytes without arriving.
__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy global -> shared (TMA), completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Issues the copy of 16x16 block `blk` into `dst`.
__device__ __forceinline__ void load_block(const int32_t* resid,
                                           long long blk, int32_t* dst,
                                           uint64_t* bar) {
  mbar_expect_tx(bar, kBlockBytes);
  bulk_g2s(dst, resid + blk * kCoeffs, kBlockBytes, bar);
}

__device__ __forceinline__ void load_quant(const int32_t* qc, Quant& kdc,
                                           Quant& kac) {
  kdc = Quant{__ldg(qc + 0), __ldg(qc + 2), __ldg(qc + 4), __ldg(qc + 6),
              __ldg(qc + 8)};
  kac = Quant{__ldg(qc + 1), __ldg(qc + 3), __ldg(qc + 5), __ldg(qc + 7),
              __ldg(qc + 9)};
}

// kRows: qc is an (S, 10) table and rows[blk] picks each block's row;
// else qc holds the ten constants of the whole batch (rows unused).
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
fused_txq16_kernel(const int32_t* __restrict__ resid, long long n_blocks,
                   const float* __restrict__ fvt,
                   const float* __restrict__ fht,
                   const int32_t* __restrict__ qc,
                   const int32_t* __restrict__ rows,
                   int32_t* __restrict__ coeff, int32_t* __restrict__ qcoeff,
                   int32_t* __restrict__ dqcoeff) {
  __shared__ __align__(128) int32_t s_in[kStages][kCoeffs];
  __shared__ __align__(16) float s_y1[kN * kPad];
  __shared__ __align__(16) float s_fvt[kCoeffs];  // s_fvt[h][i] = fv[i][h]
  __shared__ __align__(16) float s_fht[kCoeffs];  // s_fht[w][j] = fh[j][w]
  __shared__ __align__(8) uint64_t s_bar[kStages];

  const int t = threadIdx.x;
  const int w1 = t & 15;         // pass 1: column w ...
  const int r1 = (t >> 4) * 4;   // ... rows r1..r1+3 of y1
  const int i2 = t >> 2;         // pass 2: row i ...
  const int c2 = (t & 3) * 4;    // ... columns c2..c2+3 of y2
  const long long stride = gridDim.x;

  if (t == 0) {  // the matrices and the first kStages blocks go out first
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_add_tx(&s_bar[0], 2 * kBlockBytes);  // stage 0 also waits for them
    bulk_g2s(s_fvt, fvt, kBlockBytes, &s_bar[0]);
    bulk_g2s(s_fht, fht, kBlockBytes, &s_bar[0]);
    for (int s = 0; s < kStages; ++s) {
      const long long blk = blockIdx.x + s * stride;
      if (blk < n_blocks) load_block(resid, blk, s_in[s], &s_bar[s]);
    }
  }
  Quant kdc, kac;
  if (!kRows) load_quant(qc, kdc, kac);
  __syncthreads();  // barriers initialised

  int it = 0;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += stride, ++it) {
    const int s = it % kStages;
    if (kRows) load_quant(qc + 10 * (long long)__ldg(rows + blk), kdc, kac);
    mbar_wait(&s_bar[s], (it / kStages) & 1);

    // pass 1: y1[r1..r1+3][w1] = fv[r1..r1+3, :] @ x[:, w1]
    {
      const int32_t* x = s_in[s];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < kN; ++h) {
        const float xv = (float)x[h * kN + w1];
        const float4 f =
            *reinterpret_cast<const float4*>(s_fvt + h * kN + r1);
        acc[0] = __fmaf_rn(f.x, xv, acc[0]);
        acc[1] = __fmaf_rn(f.y, xv, acc[1]);
        acc[2] = __fmaf_rn(f.z, xv, acc[2]);
        acc[3] = __fmaf_rn(f.w, xv, acc[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s_y1[(r1 + k) * kPad + w1] = acc[k];
    }
    __syncthreads();  // y1 complete; buffer s read by every thread
    const long long next = blk + kStages * stride;
    if (t == 0 && next < n_blocks) {
      // order the block's reads of buffer s before the asynchronous copy
      // that refills it; the copy overlaps pass 2 and the next block
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_block(resid, next, s_in[s], &s_bar[s]);
    }

    // pass 2: y2[i2][c2..c2+3] = y1[i2, :] @ fh[c2..c2+3, :]^T, quantizer
    {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int w = 0; w < kN; ++w) {
        const float yv = s_y1[i2 * kPad + w];
        const float4 f =
            *reinterpret_cast<const float4*>(s_fht + w * kN + c2);
        acc[0] = __fmaf_rn(yv, f.x, acc[0]);
        acc[1] = __fmaf_rn(yv, f.y, acc[1]);
        acc[2] = __fmaf_rn(yv, f.z, acc[2]);
        acc[3] = __fmaf_rn(yv, f.w, acc[3]);
      }
      int v[4], q[4], d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = (int)rintf(acc[k]);
        quantize(v[k], (k == 0 && i2 == 0 && c2 == 0) ? kdc : kac, q[k],
                 d[k]);
      }
      const long long at = blk * kCoeffs + i2 * kN + c2;
      *reinterpret_cast<int4*>(coeff + at) =
          make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(qcoeff + at) =
          make_int4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<int4*>(dqcoeff + at) =
          make_int4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();  // y1 read before the next block's pass 1 writes it
  }
}

// ---------------------------------------------------------------------------
// The first kernel (kept for comparison): one thread per coefficient,
// kGroupV1 blocks per 1024-thread block, the residual, both matrices and
// y1 in shared memory.

constexpr int kGroupV1 = 4;

__global__ void __launch_bounds__(kCoeffs * kGroupV1)
fused_txq16_v1_kernel(const int32_t* __restrict__ resid, long long n_blocks,
                      const float* __restrict__ fv,
                      const float* __restrict__ fh,
                      const int32_t* __restrict__ zbin,
                      const int32_t* __restrict__ rnd,
                      const int32_t* __restrict__ quant,
                      const int32_t* __restrict__ qshift,
                      const int32_t* __restrict__ deq,
                      int32_t* __restrict__ coeff,
                      int32_t* __restrict__ qcoeff,
                      int32_t* __restrict__ dqcoeff) {
  __shared__ float s_fv[kCoeffs];
  __shared__ float s_fh[kCoeffs];
  __shared__ float s_x[kGroupV1][kCoeffs];
  __shared__ float s_y1[kGroupV1][kCoeffs];

  const int t = threadIdx.x;  // coefficient within the 16x16 block
  const int g = threadIdx.y;  // block within the group
  const int flat = g * kCoeffs + t;
  const long long blk = (long long)blockIdx.x * kGroupV1 + g;
  const bool live = blk < n_blocks;
  const long long off = blk * kCoeffs + t;

  if (flat < kCoeffs) {
    s_fv[flat] = fv[flat];
    s_fh[flat] = fh[flat];
  }
  s_x[g][t] = live ? (float)resid[off] : 0.0f;
  __syncthreads();

  const int i = t >> 4;  // output row
  const int c = t & 15;  // output column (w in pass 1, j in pass 2)
  float acc = 0.0f;
#pragma unroll
  for (int h = 0; h < kN; ++h)
    acc = __fmaf_rn(s_fv[i * kN + h], s_x[g][h * kN + c], acc);
  s_y1[g][t] = acc;
  __syncthreads();

  float acc2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kN; ++w)
    acc2 = __fmaf_rn(s_y1[g][i * kN + w], s_fh[c * kN + w], acc2);
  if (!live) return;

  const int v = (int)rintf(acc2);
  const int k = (t == 0) ? 0 : 1;  // DC constants at (0, 0)
  const Quant kq{zbin[k], rnd[k], quant[k], qshift[k], deq[k]};
  int q, dq;
  quantize(v, kq, q, dq);
  coeff[off] = v;
  qcoeff[off] = q;
  dqcoeff[off] = dq;
}

}  // namespace

// The persistent grid: kMaxPerSm thread blocks per SM of the current
// device, fewer for a small batch.  Returns a CUDA error code.
static int persistent_grid(long long n_blocks, unsigned* grid) {
  static int sms[64];  // SM count per device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long slots = (long long)sms[dev] * kMaxPerSm;
  *grid = (unsigned)(n_blocks < slots ? n_blocks : slots);
  return 0;
}

// Launches on `stream` (PyTorch's current stream); allocates nothing and
// does not synchronise.  fvt and fht are device pointers to the two
// float32 (16, 16) matrices TRANSPOSED (fvt[h][i] = fv[i][h], fht[w][j] =
// fh[j][w]); qc is a device pointer to the ten int32 quantizer constants
// ([zbin, round, quant, quant_shift, dequant] x [DC, AC]); out is a device
// (3, B, 16, 16) int32 buffer that receives coeff, qcoeff and dqcoeff.
// resid, fvt, fht and out must be 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int svt_fused_txq16(const int32_t* resid, long long n_blocks,
                               const float* fvt, const float* fht,
                               const int32_t* qc, int32_t* out,
                               void* stream) {
  if (n_blocks <= 0) return 0;
  unsigned grid = 0;
  const int err = persistent_grid(n_blocks, &grid);
  if (err) return err;
  const long long plane = n_blocks * kCoeffs;
  fused_txq16_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      resid, n_blocks, fvt, fht, qc, nullptr, out, out + plane,
      out + 2 * plane);
  return (int)cudaGetLastError();
}

// The per-row form: qtab is a device pointer to an (n_rows, 10) int32
// table of packed constants (each row laid out as qc above) and rows a
// device pointer to n_blocks int32 row indices in [0, n_rows); the
// caller checks the range.  Same grid, same arithmetic.
extern "C" int svt_fused_txq16_rows(const int32_t* resid, long long n_blocks,
                                    const float* fvt, const float* fht,
                                    const int32_t* qtab, const int32_t* rows,
                                    int32_t* out, void* stream) {
  if (n_blocks <= 0) return 0;
  unsigned grid = 0;
  const int err = persistent_grid(n_blocks, &grid);
  if (err) return err;
  const long long plane = n_blocks * kCoeffs;
  fused_txq16_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      resid, n_blocks, fvt, fht, qtab, rows, out, out + plane,
      out + 2 * plane);
  return (int)cudaGetLastError();
}

// The first kernel, same results; fv, fh and the five quantizer arrays
// ((2,) int32 each, [DC, AC]) are device pointers.
extern "C" int svt_fused_txq16_v1(const int32_t* resid, long long n_blocks,
                                  const float* fv, const float* fh,
                                  const int32_t* zbin, const int32_t* rnd,
                                  const int32_t* quant, const int32_t* qshift,
                                  const int32_t* deq, int32_t* coeff,
                                  int32_t* qcoeff, int32_t* dqcoeff,
                                  void* stream) {
  if (n_blocks <= 0) return 0;
  const dim3 block(kCoeffs, kGroupV1);
  const dim3 grid((unsigned)((n_blocks + kGroupV1 - 1) / kGroupV1));
  fused_txq16_v1_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      resid, n_blocks, fv, fh, zbin, rnd, quant, qshift, deq, coeff, qcoeff,
      dqcoeff);
  return (int)cudaGetLastError();
}
