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
// Bound on the H100: per block 2 * 2 * 16^3 = 16 KFLOP of float32 work
// against 1 KB read and 3 KB written (4 KB moved), about 4 FLOP/byte,
// far below the card's float32 ridge; at the main path's batch (a few
// thousand blocks per call) the kernel is bound by memory and by launch
// latency, not by arithmetic.  So the design keeps it simple: one
// thread block per group of kGroup 16x16 blocks, 256 threads per block
// (one per coefficient), the residual and both matrices staged in shared
// memory, the intermediate y1 kept in shared memory (never in device
// memory), and the three outputs written once, coalesced.
//
// Summation order: each output is one thread's sequential fused
// multiply-add chain, k = 0..15 in increasing order (__fmaf_rn, one
// rounding per step).  It is a fixed order, but not the order of cuBLAS
// (the plain PyTorch version on the card) nor of XLA, so a coefficient
// whose exact value lies on a .5 rounding tie may differ by one from
// theirs; the quantizer then runs on this kernel's own coefficients.
//
// Rounding: rintf rounds half to even, like jnp.round and torch.round;
// roundf (half away from zero) would not match them.
//
// Integer safety: the quantizer runs in int32 in the reference's
// operation order.  |tmp| <= 32767 after the clip, |quant| <= 2^15 and
// quant_shift <= 2^14 (quantizer steps are >= 4), so tmp * quant and
// ((tmp * quant >> 16) + tmp) * quant_shift stay below 2^31 and never
// wrap; >> on a negative int is an arithmetic shift, as in the
// reference.  The ragged last group is masked in the kernel: no padding
// copy of the input is made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;
constexpr int kCoeffs = kN * kN;
constexpr int kGroup = 4;  // 16x16 blocks per thread block (1024 threads)

__global__ void __launch_bounds__(kCoeffs * kGroup)
fused_txq16_kernel(const int32_t* __restrict__ resid, long long n_blocks,
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
  __shared__ float s_x[kGroup][kCoeffs];
  __shared__ float s_y1[kGroup][kCoeffs];

  const int t = threadIdx.x;  // coefficient within the 16x16 block
  const int g = threadIdx.y;  // block within the group
  const int flat = g * kCoeffs + t;
  const long long blk = (long long)blockIdx.x * kGroup + g;
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
  const int a = v < 0 ? -v : v;
  int tmp = a + rnd[k];
  tmp = tmp < -32768 ? -32768 : (tmp > 32767 ? 32767 : tmp);
  int q = ((((tmp * quant[k]) >> 16) + tmp) * qshift[k]) >> 16;
  if (a < zbin[k]) q = 0;
  const int dq = q * deq[k];
  coeff[off] = v;
  qcoeff[off] = v < 0 ? -q : q;
  dqcoeff[off] = v < 0 ? -dq : dq;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing and
// does not synchronise.  Returns cudaGetLastError() after the launch.
extern "C" int svt_fused_txq16(const int32_t* resid, long long n_blocks,
                               const float* fv, const float* fh,
                               const int32_t* zbin, const int32_t* rnd,
                               const int32_t* quant, const int32_t* qshift,
                               const int32_t* deq, int32_t* coeff,
                               int32_t* qcoeff, int32_t* dqcoeff,
                               void* stream) {
  if (n_blocks <= 0) return 0;
  const dim3 block(kCoeffs, kGroup);
  const dim3 grid((unsigned)((n_blocks + kGroup - 1) / kGroup));
  fused_txq16_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      resid, n_blocks, fv, fh, zbin, rnd, quant, qshift, deq, coeff, qcoeff,
      dqcoeff);
  return (int)cudaGetLastError();
}
