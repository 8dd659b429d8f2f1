// Pairwise Hamming distances between packed 256-bit ORB descriptors on the
// binary tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gf_orb_slam_tpu/ops/pallas_kernels.py::
// hamming_matrix_pallas (body _hamming_kernel): out[i, j] = sum over the 8
// words of popcount(q[i, w] ^ t[j, w]), (Nq, 8) x (Nt, 8) words -> (Nq, Nt)
// int32. The TPU kernel zero-pads both inputs to multiples of 128 and XORs
// and popcounts 128 x 128 tiles on the vector unit; nothing of its tiling is
// kept here.
//
// What bounds it on the H100: the output write. The kernel reads
// 32 (Nq + Nt) bytes and writes 4 Nq Nt, which at 3.35 TB/s is 3.96 us at
// the tracking path's local-map match (4096 x 800), 0.78 us at 800 x 800,
// 1.55 us at 1600 x 800, 3.09 us at 1600 x 1600 and 3.95 us at 2048 x 1600.
// A SIMT version (hamming_simt.cu) spends 8 XORs, 8 popcounts and 8 adds on
// the CUDA cores per output: 26.2 M popcounts at 4096 x 800, which at about
// 16 popcounts per clock per SM on 132 SMs at <= 1.98 GHz need >= 6.3 us,
// so it cannot pass ~60% of the byte bound before any other cost.
//
// The design moves the arithmetic to the tensor cores and leaves the store:
// - H(q, t) = popc(q) + popc(t) - 2 popc(q AND t). The AND-popcount over
//   all 256 bits is one mma.sync.m16n8k256 .b1 .and.popc per 16 x 8 output
//   tile: an A row is one query descriptor, a B column one target
//   descriptor, 32 bytes each, and the s32 accumulator is the popcount.
//   (AND, not XOR: sm_90a has no XOR binary MMA; ptxas lowers .xor.popc to
//   two AND MMAs on complemented operands.)
// - popc(q) and popc(t) come once per row from the staged tile (8 __popc
//   per row, not per pair).
// - Staging: the descriptor tiles are a few KB, so plain 16-byte vector
//   loads into shared memory do; TMA would add setup and no bandwidth.
//   Rows are padded to 12 words so the fragment loads (row g, word tig) hit
//   32 distinct banks. Rows beyond Nq / Nt are zero.
// - Epilogue: each warp writes its 16 x BN result strip to shared memory
//   (rows padded by 8 words: conflict-free int2 writes) and stores it with
//   16-byte, fully coalesced row stores; a ragged Nt, a row pitch that is
//   not a multiple of 4 or an unaligned output falls back to masked scalar
//   stores. Outputs of rows or columns beyond Nq / Nt are never stored, so
//   there is no pad or crop copy.
// - Filling the card: one warp per 16-row strip, 64 x 32 tiles (BM x BN),
//   four warps per block: 325 blocks at 800 x 800 and more at every other
//   path shape, against 132 SMs. kernels/hamming.py::launch_config computes
//   the grid, the block and the dynamic shared memory and passes them in;
//   this file checks them against its own layout. Narrow strips win: ptxas
//   issues a strip's MMAs one after another on one register quad, and the
//   binary MMA's latency on sm_90a is long, so BN = 32 (4 MMAs per warp) and
//   many resident warps hide it best. On an H100, 64 x 32 was the fastest
//   or within noise of the fastest tile at each path shape (PERF.md).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a launch
// configuration other than its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;             // 256 bits
constexpr int kStride = 12;           // shared words per staged descriptor row
constexpr int kPad = 8;               // int32 pad per row of a warp's result strip
constexpr int BM = 64;                // query rows per block
constexpr int BN = 32;                // target columns per block
constexpr int kThreads = 2 * BM;      // one warp per 16-row strip
constexpr int kSmemBytes = 4 * ((BM + BN) * kStride + (BM + BN) + BM * (BN + kPad));

// d = popc(A AND B) for a 16 x 8 tile over k = 256 bits.
__device__ __forceinline__ void mma_and_popc(const uint32_t (&a)[4], const uint32_t (&b)[2], int (&d)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0), "r"(0), "r"(0), "r"(0));
}

__global__ void __launch_bounds__(kThreads)
hamming_mma_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t, int32_t* __restrict__ out,
                   int nq, int nt, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* sq = smem;                                    // BM query rows, then BN target rows
  uint32_t* st = sq + BM * kStride;
  int* pc = reinterpret_cast<int*>(st + BN * kStride);    // popc of each staged row
  constexpr int kLd = BN + kPad;
  int* strip = pc + BM + BN + (threadIdx.x >> 5) * 16 * kLd;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // Stage the BM + BN rows, two 16-byte halves each (zero past Nq / Nt), and
  // sum each row's popcount over its halves, which sit in adjacent lanes.
  // 2 (BM + BN) and the block are multiples of 32: whole warps run the loop.
  for (int i = threadIdx.x; i < 2 * (BM + BN); i += kThreads) {
    const int r = i >> 1, h = i & 1;
    const bool is_q = r < BM;
    const int row = is_q ? m0 + r : n0 + r - BM;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < (is_q ? nq : nt)) {
      const uint32_t* p = (is_q ? q : t) + (size_t)row * kWords + 4 * h;
      v = vec_in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
    *reinterpret_cast<uint4*>(sq + r * kStride + 4 * h) = v;
    int c = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    if (h == 0) pc[r] = c;
  }
  __syncthreads();

  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's strip
  if (m0 + r0 >= nq) return;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group, thread in group
  // A fragment: rows g and g + 8, words tig (k 0..127) and 4 + tig (k 128..255).
  const uint32_t* qa = sq + (r0 + g) * kStride;
  const uint32_t a[4] = {qa[tig], qa[8 * kStride + tig], qa[4 + tig], qa[8 * kStride + 4 + tig]};
  const int p0 = pc[r0 + g], p1 = pc[r0 + g + 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const uint32_t* tb = st + (8 * j + g) * kStride;     // B column g: one target
    const uint32_t b[2] = {tb[tig], tb[4 + tig]};
    int d[4];
    mma_and_popc(a, b, d);
    const int c = 8 * j + 2 * tig;                       // accumulator columns c, c + 1
    const int t0 = pc[BM + c], t1 = pc[BM + c + 1];
    *reinterpret_cast<int2*>(strip + g * kLd + c) = make_int2(p0 + t0 - 2 * d[0], p0 + t1 - 2 * d[1]);
    *reinterpret_cast<int2*>(strip + (g + 8) * kLd + c) = make_int2(p1 + t0 - 2 * d[2], p1 + t1 - 2 * d[3]);
  }
  __syncwarp();
  constexpr int kChunks = BN / 4;  // int4 per strip row
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, ch = i % kChunks;
    const int row = m0 + r0 + r, col = n0 + 4 * ch;
    if (row >= nq || col >= nt) continue;
    const int4 v = *reinterpret_cast<const int4*>(strip + r * kLd + 4 * ch);
    int32_t* dst = out + (size_t)row * nt + col;
    if (vec_out) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (col + 1 < nt) dst[1] = v.y;
      if (col + 2 < nt) dst[2] = v.z;
      if (col + 3 < nt) dst[3] = v.w;
    }
  }
}

}  // namespace

extern "C" int gf_hamming_matrix(const void* q, const void* t, void* out, int nq, int nt, int bm, int bn,
                                 int grid_x, int grid_y, int block, int smem, void* stream) {
  if (nq <= 0 || nt <= 0) return 0;
  if (bm != BM || bn != BN || block != kThreads || smem != kSmemBytes || grid_x != (nt + BN - 1) / BN ||
      grid_y != (nq + BM - 1) / BM)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  // With Nt % 4 == 0 every 4-column chunk that starts inside a row ends inside it.
  const bool vec_out = nt % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  hamming_mma_kernel<<<dim3(grid_x, grid_y), block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t), static_cast<int32_t*>(out), nq, nt,
      vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
