// Pairwise Hamming distances on the CUDA cores (XOR + __popc per word): the
// first Hopper design of gf_orb_slam_tpu/ops/pallas_kernels.py::
// hamming_matrix_pallas. The main path runs the tensor-core kernel of
// hamming.cu; this one stays as the baseline that chip_smoke.py times beside
// it in the same run (kernels/hamming.py::hamming_matrix_simt_cuda).
//
// What bounds it: 8 XORs, 8 popcounts and 8 adds per output on the CUDA
// cores, and 8 shared-memory reads; at about 16 popcounts per clock per SM
// the popcounts alone need >= 6.3 us at 4096 x 800, against a byte bound of
// 3.96 us (hamming.cu). threadIdx.x runs along Nt and each warp stores 32
// consecutive int32 of one output row; both descriptor tiles are staged in
// shared memory once per block, a thread keeps its target's 8 words in
// registers and reads query words as broadcasts.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;               // 256 bits
constexpr int kTileT = 32;              // targets per block = blockDim.x
constexpr int kRows = 8;                // blockDim.y
constexpr int kTileQ = 32;              // queries per block
constexpr int kQPerThread = kTileQ / kRows;
static_assert(kTileQ * kWords == kTileT * kRows, "one query-tile word per thread");
static_assert(kTileT * kWords == kTileT * kRows, "one target-tile word per thread");

__global__ void __launch_bounds__(kTileT * kRows)
hamming_simt_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                    int32_t* __restrict__ out, int nq, int nt) {
  __shared__ uint32_t sq[kTileQ][kWords];
  __shared__ uint32_t st[kTileT][kWords + 1];  // +1: conflict-free column reads

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int q0 = blockIdx.y * kTileQ;
  const int t0 = blockIdx.x * kTileT;

  // Stage both tiles: thread `lin` loads word lin % 8 of row lin / 8.
  const int lin = ty * kTileT + tx;
  const int r = lin / kWords;
  const int w = lin % kWords;
  sq[r][w] = (q0 + r < nq) ? q[(size_t)(q0 + r) * kWords + w] : 0u;
  st[r][w] = (t0 + r < nt) ? t[(size_t)(t0 + r) * kWords + w] : 0u;
  __syncthreads();

  const int col = t0 + tx;
  if (col >= nt) return;
  uint32_t tw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) tw[k] = st[tx][k];

#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    const int rr = ty + i * kRows;
    const int row = q0 + rr;
    if (row < nq) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) acc += __popc(sq[rr][k] ^ tw[k]);
      out[(size_t)row * nt + col] = acc;
    }
  }
}

}  // namespace

extern "C" int gf_hamming_matrix_simt(const void* q, const void* t, void* out, int nq, int nt, void* stream) {
  if (nq <= 0 || nt <= 0) return 0;
  const dim3 block(kTileT, kRows);
  const dim3 grid((nt + kTileT - 1) / kTileT, (nq + kTileQ - 1) / kTileQ);
  hamming_simt_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
      static_cast<int32_t*>(out), nq, nt);
  return static_cast<int>(cudaGetLastError());
}
