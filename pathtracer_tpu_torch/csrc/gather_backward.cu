// The material gathers' backward for Hopper (sm_90a): a deterministic sum of
// rows by id, out[m, c] = sum over i with ids[i] = m of grad[i, c].
//
// Replaces no TPU kernel. The JAX package's material lookup
// (pathtracer_tpu/ops/intersect.py `material_lookup`) is a one-hot [B, M] by
// [M, 12] product, so its backward is XLA's dense reduction over B; its
// light Ke (pathtracer_tpu/ops/lights.py) an XLA gather. The port gathers
// rows by id (ops/gather.py `GatherRows`), and autograd's own backward of
// that, `_index_put_impl_` with accumulate, sorts the ids and then gives each
// distinct id to one warp, which walks its duplicates one after another: with
// the Cornell box's 5 materials, about 50,000 rows a warp, 19-42 ms a call.
//
// Contract (ops/gather.py `segment_sum`; its plain version, a zero table and
// `_index_put_impl_`, is the oracle up to the order of the float sums):
//   grad [n, k] f32 and ids [n] (int64 or int32), contiguous; out [m, k] f32,
//   every element written, +0.0 where no row adds to it. A negative id counts
//   from the end, as indexing does; an id outside [-m, m) adds nothing.
//
// Deterministic. The same inputs give the same bits on every run and every
// card: no float atomics; every sum is taken in an order that the launch
// configuration fixes, and that depends on n, m and k alone.
//   Pass 1 (`segment_sum_partial`): block x takes the rows of its grid-stride
//     share in kBatch-row batches. Each thread keeps its bins in registers and
//     adds its rows in row order; a warp sums each bin by a fixed shuffle
//     tree; the block adds its warps in warp order and writes its partial row
//     partial[x, :]. No sort.
//   Pass 2 (`segment_sum_finish`): one warp per table element sums the blocks'
//     partials, lane l the blocks l, l + 32, ... in order, then a shuffle tree,
//     and writes it. That is also the zero fill.
// Two launches a call; at 262,144 rows, 256 partial rows (15 KB for [5, 3]).
//
// Adapting to the table. Registers cannot be indexed by a value, so a thread
// holds kBins bins, one tile of the table's m * k elements, and adds a value
// to bin b by a compare and select over the tile. The Cornell tables (m * k
// 15 and 5) are one tile. A larger table splits the grid's second dimension
// over tiles: each block bins only the elements of its tile, reading every
// row's id and only the gradient values that fall in the tile, and the
// partials stay [blocks, m, k]. The row blocks shrink so that the partials
// stay under kMaxPartials floats. So a table of m * k elements reads the ids
// m * k / kBins times, from L2: the price of exact, ordered sums with no
// sort, which only a table far larger than a scene's materials pays.
//
// What bounds it on the card: bytes, once. A call reads n * k floats and n
// ids and writes m * k floats: at 262,144 rows, 5.24 MB for k = 3 and 3.15 MB
// for k = 1, 1.57 and 0.94 us at 3.35 TB/s. At that size the time is the two
// launches and the chain of dependent loads in a thread (ids, then values),
// which a batch of kBatch rows issues together. Measured (chip_smoke.py, an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6): 6.17 us into
// [5, 3] and 5.94 us into [5], both launches, a CUDA graph of 100 calls.

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 16;            // table elements a thread bins at once
constexpr int kBatch = 4;            // rows a thread loads before it adds them
constexpr int kRowsPerBlock = kThreads * kBatch;
constexpr long long kMaxRowBlocks = 256;
constexpr long long kMaxPartials = 1LL << 22;  // floats of the partial rows, 16 MB
constexpr int kMaxTileBlocks = 65535;   // the grid's second dimension
constexpr int kMaxFinishBlocks = 4096;
constexpr long long kSkip = 1LL << 62;  // a row's offset when it adds nothing

// Blocks of pass 1 over the rows: enough for kBatch rows a thread, at most
// kMaxRowBlocks, and few enough that [blocks, m * k] partials fit
// kMaxPartials.
long long row_blocks(long long n, long long mk) {
  if (n <= 0) return 0;
  long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  const long long cap = kMaxPartials / mk;
  return blocks < cap ? blocks : (cap > 1 ? cap : 1);
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
segment_sum_partial(const float* __restrict__ grad, const Id* __restrict__ ids, long long n,
                    long long m, long long k, long long tiles, float* __restrict__ partial) {
  __shared__ float warp_sums[kWarps][kBins];
  const long long mk = m * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first_row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long lo = tile * kBins;  // the tile's first table element
    float acc[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) acc[b] = 0.0f;
    for (long long base = first_row; base < n; base += step) {
      // Each row's first element relative to the tile (kSkip: none).
      long long e0[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = base + u * kThreads;
        e0[u] = kSkip;
        if (r < n) {
          long long id = static_cast<long long>(ids[r]);
          if (id < 0) id += m;
          if (id >= 0 && id < m) e0[u] = id * k - lo;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = base + u * kThreads;
        // The row's columns that fall in the tile.
        const long long c_lo = e0[u] < 0 ? -e0[u] : 0;
        const long long c_hi = kBins - e0[u] < k ? kBins - e0[u] : k;
        for (long long c = c_lo; c < c_hi; ++c) {
          const float v = grad[r * k + c];
          const int e = static_cast<int>(e0[u] + c);
#pragma unroll
          for (int b = 0; b < kBins; ++b) acc[b] = e == b ? acc[b] + v : acc[b];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      float s = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) warp_sums[warp][b] = s;
    }
    __syncthreads();
    if (threadIdx.x < kBins && lo + threadIdx.x < mk) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
      partial[blockIdx.x * mk + lo + threadIdx.x] = s;
    }
    __syncthreads();  // warp_sums is the next tile's
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_finish(const float* __restrict__ partial, long long blocks, long long mk,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long e = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); e < mk;
       e += warps) {
    float s = 0.0f;
    for (long long x = lane; x < blocks; x += 32) s += partial[x * mk + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[e] = s;
  }
}

template <typename Id>
int launch(const float* grad, const Id* ids, long long n, long long m, long long k,
           long long blocks, float* partial, float* out, cudaStream_t stream) {
  const long long mk = m * k;
  if (blocks > 0) {
    const long long tiles = (mk + kBins - 1) / kBins;
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(tiles < kMaxTileBlocks ? tiles : kMaxTileBlocks));
    segment_sum_partial<Id><<<grid, kThreads, 0, stream>>>(grad, ids, n, m, k, tiles, partial);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long finish = (mk + kWarps - 1) / kWarps;
  segment_sum_finish<<<static_cast<unsigned>(finish < kMaxFinishBlocks ? finish
                                                                       : kMaxFinishBlocks),
                       kThreads, 0, stream>>>(partial, blocks, mk, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of the partial buffer that pt_segment_sum takes for n rows into an
// [m, k] table (0 for n = 0): the caller allocates blocks * m * k floats.
int pt_segment_sum_blocks(int n, int m, int k) {
  if (n < 0 || m < 1 || k < 1) return 0;
  return static_cast<int>(row_blocks(n, static_cast<long long>(m) * k));
}

// out [m, k] = the rows of grad [n, k] summed by ids [n] (id_bytes 8: int64,
// 4: int32), through partial [blocks, m, k] with blocks from
// pt_segment_sum_blocks; launches on `stream` and returns the first CUDA
// error.
int pt_segment_sum(const float* grad, const void* ids, int id_bytes, int n, int m, int k,
                   int blocks, float* partial, float* out, void* stream) {
  if (n < 0 || m < 1 || k < 1 || blocks != pt_segment_sum_blocks(n, m, k) ||
      (id_bytes != 4 && id_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return id_bytes == 8
             ? launch(grad, static_cast<const int64_t*>(ids), n, m, k, blocks, partial, out, s)
             : launch(grad, static_cast<const int32_t*>(ids), n, m, k, blocks, partial, out, s);
}

}  // extern "C"
