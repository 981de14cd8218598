// Sparse 3x3x3 convolution of the voxel table (middle block 1, the
// `sparse1` lowering): the occupancy map, the sum of the per-offset
// products into the output grid, and its gradient.
//
// Replaces XLA code, not a Pallas kernel: the 27 scatter-adds of
// voxelnet_tpu/models/sparse_conv.py::sparse_conv3x3 (:92-108) and the
// gather that JAX's autodiff makes of them. The product vals = feat @ wmat,
// (B, K, 27, C) with o = (kd * 3 + ky) * 3 + kx, is a torch matmul before
// these kernels (kernels/sparse_conv.py). JAX scatters and needs no map;
// the output-stationary sum looks its taps up in one.
//
// occupancy_kernel is a streaming build of the map, as dense_build.cu
// builds the grid: it takes the voxelizers' order (per frame the live
// rows' cell ids ascend strictly, padding rows trail) and writes every
// cell exactly once, the row k where a live voxel sits and -1 elsewhere,
// in one launch with no fill before it. A live voxel outside the grid, or
// a live row out of that order, traps. It writes the 4-byte map (45 MB at
// Car B=8) and reads the table once: device-memory bytes bound it. What
// holds it back is each block's chain of dependent loads (the search,
// then its rows) before its stores; 8192 cells a block halve the chains
// that 4096 would take.
//
// sparse_conv_fwd_kernel is output-stationary, bit-equal to JAX's
// sequence of f32 additions: for each 16-byte chunk of an output site,
// f32 accumulators start at 0, the occupied taps' values (widened to f32)
// are added in offset order, the f32 bias last, and the sum is rounded
// once (then the optional ReLU). Each chunk is written exactly once, with
// no atomics and no read-modify-write of the output.
//
// What bounds it on an H100: device-memory bytes, mostly the output write.
// At Car B=8 it writes the (8, 5, 400, 352, 64) bf16 output (721 MB),
// reads the ~13k occupied voxels' taps a frame and the 45 MB map. A voxel
// reaches ~15% of the sites, so most of the output is the bias. The design:
// - persistent blocks, as many as are resident on the card, draw tiles of
//   8 output rows x 32 sites at one (b, oz) from a counter, so the dense
//   tiles near the sensor spread over the blocks;
// - a tile's map cells, 3 depths x 10 rows x 34 columns, are staged in
//   shared memory with cp.async, double-buffered: the next tile's cells
//   are in flight while this tile is stored. Each map entry is read
//   ~1.33 times for each output depth that uses it;
// - a warp a row ORs the staged taps into a 32-bit word of the row's sites
//   that some voxel reaches (ballots), and lists them;
// - every other site stores the bias chunk (0 + bias, rounded, ReLU'd),
//   held in registers: a stream of 16-byte coalesced stores;
// - the reached sites' chunks are spread over all threads; each lists its
//   site's occupied taps from the stage and loads them 4 at a time, in
//   offset order (an empty slot loads +0, which leaves an accumulator that
//   started at +0 unchanged: it is never -0), so a site of up to 4 taps
//   waits for one round trip to memory.
// Output stores and tap loads carry the streaming hint: each is touched
// once.
//
// sparse_conv_grad_kernel is voxel-centric, as JAX's autodiff of the
// scatter is: a thread per 16-byte chunk of dvals[b, k, o], which is the
// output cotangent at the site that (k, o) reaches, or 0 where the tap
// misses (depth-stride parity, grid bounds, the x window) or k is padding.
// It moves chunks and never looks at the values, so it serves every type.
// At Car B=8 it writes the (8, 16384, 27, 64) bf16 dvals (453 MB) and
// reads at most as much.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "sorted_ids.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a tile: kTileY output rows (one warp each for the hit words) x kTileX
// sites (one lane each), so one site per thread
constexpr int kTileY = kWarps;
constexpr int kTileX = 32;
// its staged map cells: 3 depths x (kTileY + 2) rows x (kTileX + 2) columns
constexpr int kCellsY = kTileY + 2;
constexpr int kCellsX = kTileX + 2;
constexpr int kCells = 3 * kCellsY * kCellsX;
// occupied taps of a site loaded together: 4 keeps the forward at 80
// registers, 3 blocks an SM, no spills (8: 97 registers, 2 blocks)
constexpr int kTapBatch = 4;
constexpr int kMaxDevices = 64;
// map cells a block of the occupancy kernel owns: 32 KB of shared memory,
// 7 blocks an SM
constexpr int kOccCells = 8192;

template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void add(float* acc, const uint4& u) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      acc[2 * e] += f.x;
      acc[2 * e + 1] += f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __halves2bfloat162(__float2bfloat16_rn(v[2 * e]),
                                __float2bfloat16_rn(v[2 * e + 1]));
    return u;
  }
};

template <>
struct Chunk<float> {
  static constexpr int kPer = 4;
  __device__ static void add(float* acc, const uint4& u) {
    acc[0] += __uint_as_float(u.x);
    acc[1] += __uint_as_float(u.y);
    acc[2] += __uint_as_float(u.z);
    acc[3] += __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// acc + bias, rounded to T, then ReLU where asked. The rounding keeps sign
// and order, so the ReLU of the sum is the ReLU of the rounded value; a
// NaN stays NaN, as under torch.relu.
template <typename T>
__device__ uint4 finish(float* acc, const float* bias, bool relu) {
  constexpr int kPer = Chunk<T>::kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const float v = acc[e] + bias[e];
    acc[e] = relu && v < 0.f ? 0.f : v;
  }
  return Chunk<T>::pack(acc);
}

struct Geometry {
  int K, D, H, W, Do, stride_d, pad_d, x0, wloc, chunks, tiles_x, tiles_y,
      tiles;
};

// tile t -> (b, oz, first output row, first local column); x fastest
struct Tile {
  int b, oz, oy0, ox0;
  __device__ Tile(const Geometry& g, int t) {
    const int tx = t % g.tiles_x;
    t /= g.tiles_x;
    const int ty = t % g.tiles_y;
    t /= g.tiles_y;
    oz = t % g.Do;
    b = t / g.Do;
    oy0 = ty * kTileY;
    ox0 = tx * kTileX;
  }
};

__device__ void cp_async4(int* dst, const int* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
}

__device__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// *p where take, else +0: a predicated streaming load, so the 9 taps of a
// depth are in flight together and a missing one reads nothing
__device__ uint4 load_tap(const uint4* p, bool take) {
  uint4 v;
  asm volatile(
      "{\n"
      "  .reg .pred p;\n"
      "  setp.ne.b32 p, %5, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @p ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)take));
  return v;
}

// cells[kd][yy][xx] <- the map at (oz * s - pad + kd, oy0 - 1 + yy,
// x0 + ox0 - 1 + xx), by cp.async; -1 off the grid, stored directly
__device__ void stage_cells(int* cells, const int* __restrict__ occ,
                            const Geometry& g, const Tile& t) {
  const int* frame = occ + (size_t)t.b * g.D * g.H * g.W;
  for (int i = threadIdx.x; i < kCells; i += kThreads) {
    const int kd = i / (kCellsY * kCellsX);
    const int r = i - kd * (kCellsY * kCellsX);
    const int yy = r / kCellsX;
    const int xx = r - yy * kCellsX;
    const int z = t.oz * g.stride_d - g.pad_d + kd;
    const int y = t.oy0 - 1 + yy;
    const int x = g.x0 + t.ox0 - 1 + xx;
    if (z >= 0 && z < g.D && y >= 0 && y < g.H && x >= 0 && x < g.W)
      cp_async4(cells + i, frame + ((size_t)z * g.H + y) * g.W + x);
    else
      cells[i] = -1;
  }
}

// the cell offset in a tile's stage of tap o = (kd * 3 + ky) * 3 + kx from
// its site's (kd = 0, ky = 0, kx = 0) cell
__device__ int tap_cell(int o) {
  return (o / 9) * kCellsY * kCellsX + (o / 3 % 3) * kCellsX + o % 3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_conv_fwd_kernel(const uint4* __restrict__ vals,  // (B, K, 27, chunks)
                       const int* __restrict__ occ,     // (B, D, H, W)
                       const float* __restrict__ bias,  // (C,)
                       uint4* __restrict__ out,  // (B, Do, H, wloc, chunks)
                       int* __restrict__ next,  // tiles handed out, from 0
                       Geometry g, int relu) {
  constexpr int kPer = Chunk<T>::kPer;
  __shared__ int cells[2][kCells];
  __shared__ int tiles[2];                       // this and the next tile
  __shared__ unsigned hit_word[kTileY];          // bit tx: site reached
  __shared__ unsigned char hit_x[kTileY][kTileX];  // reached tx, in order
  const int chunks = g.chunks;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // chunks divides kThreads: a thread's chunk is the same at every site it
  // takes, `step` sites apart
  const int c = threadIdx.x % chunks;
  const int site0 = threadIdx.x / chunks;
  const int step = kThreads / chunks;
  float b_c[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) b_c[e] = bias[c * kPer + e];
  float zero[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) zero[e] = 0.f;
  const uint4 empty = finish<T>(zero, b_c, relu);

  // tiles are handed out one at a time, so a block that draws the dense
  // tiles near the sensor draws fewer of them
  if (threadIdx.x == 0) {
    tiles[0] = atomicAdd(next, 1);
    tiles[1] = atomicAdd(next, 1);
  }
  __syncthreads();
  if (tiles[0] < g.tiles) stage_cells(cells[0], occ, g, Tile(g, tiles[0]));
  cp_async_commit();
  for (int it = 0;; ++it) {
    const int t = tiles[it & 1];
    if (t >= g.tiles) break;
    const int* rows = cells[it & 1];
    // this tile's cells have landed, and every thread is done with the
    // other buffer, the hit lists of the tile before and the tile number
    // drawn two tiles ago
    cp_async_wait_all();
    __syncthreads();
    const int t_next = tiles[(it + 1) & 1];
    if (t_next < g.tiles)
      stage_cells(cells[(it + 1) & 1], occ, g, Tile(g, t_next));
    cp_async_commit();
    if (threadIdx.x == 0) tiles[it & 1] = atomicAdd(next, 1);

    const Tile tile(g, t);
    const int ny = min(kTileY, g.H - tile.oy0);
    const int nx = min(kTileX, g.wloc - tile.ox0);
    const unsigned valid_x = nx == 32 ? ~0u : (1u << nx) - 1;
    // warp w: the sites of row w that some staged tap reaches
    {
      bool lo = false, hi = false;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int* r = rows + (kd * kCellsY + warp + ky) * kCellsX;
          lo |= r[lane] >= 0;
          if (lane < kCellsX - 32) hi |= r[32 + lane] >= 0;
        }
      const unsigned long long v =
          __ballot_sync(~0u, lo) |
          (unsigned long long)__ballot_sync(~0u, hi) << 32;
      // cells xx = tx, tx + 1, tx + 2 are the site's kx = 0, 1, 2
      unsigned h = (unsigned)(v | v >> 1 | v >> 2) & valid_x;
      if (warp >= ny) h = 0;
      if (lane == 0) hit_word[warp] = h;
      if (h >> lane & 1) hit_x[warp][__popc(h & ((1u << lane) - 1))] = lane;
    }
    __syncthreads();

    const size_t row0 = ((size_t)tile.b * g.Do + tile.oz) * g.H + tile.oy0;
    // the sites no tap reaches: the bias chunk
    for (int s = site0; s < kTileY * kTileX; s += step) {
      const int ty = s / kTileX;
      const int tx = s % kTileX;
      if (ty < ny && tx < nx && !(hit_word[ty] >> tx & 1))
        __stcs(out + ((row0 + ty) * g.wloc + tile.ox0 + tx) * chunks + c,
               empty);
    }
    // the reached sites, their chunks spread over all threads; ends[r]:
    // the reached sites of rows 0..r
    int ends[kTileY];
#pragma unroll
    for (int r = 0; r < kTileY; ++r)
      ends[r] = (r ? ends[r - 1] : 0) + __popc(hit_word[r]);
    const uint4* src = vals + (size_t)tile.b * g.K * 27 * chunks + c;
    for (int hit = site0; hit < ends[kTileY - 1]; hit += step) {
      int ty = 0, first = 0;
#pragma unroll
      for (int r = 0; r < kTileY - 1; ++r)
        if (hit >= ends[r]) {
          ty = r + 1;
          first = ends[r];
        }
      const int tx = hit_x[ty][hit - first];
      const int* cell = rows + ty * kCellsX + tx;
      unsigned taps = 0;  // bit o: tap o occupied
#pragma unroll
      for (int o = 0; o < 27; ++o)
        taps |= (unsigned)(cell[tap_cell(o)] >= 0) << o;
      float acc[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
      // the occupied taps in offset order, kTapBatch loads in flight
      while (taps) {
        uint4 v[kTapBatch];
#pragma unroll
        for (int q = 0; q < kTapBatch; ++q) {
          const int o = taps ? __ffs(taps) - 1 : 0;
          const int row = taps ? cell[tap_cell(o)] : 0;
          v[q] = load_tap(src + ((size_t)row * 27 + o) * chunks, taps != 0);
          taps &= taps - 1;
        }
#pragma unroll
        for (int q = 0; q < kTapBatch; ++q) Chunk<T>::add(acc, v[q]);
      }
      __stcs(out + ((row0 + ty) * g.wloc + tile.ox0 + tx) * chunks + c,
             finish<T>(acc, b_c, relu));
    }
  }
}

// the linear cell id (z * H + y) * W + x of each row of one frame, n =
// D * H * W for a padding row (count 0), as the map's search reads them.
// The four loads do not wait on each other; a live row outside the grid
// gets some id (the row check traps on it).
struct TableIds {
  const int* __restrict__ coords;  // (K, 3) zyx
  const int* __restrict__ counts;  // (K,)
  int H, W, n;
  __device__ int operator()(int k) const {
    const int c = counts[k];
    const unsigned z = coords[3 * k], y = coords[3 * k + 1],
                   x = coords[3 * k + 2];
    return c > 0 ? (int)((z * H + y) * W + x) : n;
  }
};

// The map's contract for row i = (b, k) of the (B, K) table: a live row
// lies inside the grid, and a live row k + 1 follows a live row k at a
// larger cell id (padding rows trail). Traps otherwise, so the call's next
// synchronisation raises (the plain version raises ValueError).
__device__ void check_row(const int* __restrict__ coords,
                          const int* __restrict__ counts, long long i, int k,
                          int K, int D, int H, int W) {
  const bool live = counts[i] > 0;
  const int z = coords[3 * i], y = coords[3 * i + 1], x = coords[3 * i + 2];
  if (live && (z < 0 || z >= D || y < 0 || y >= H || x < 0 || x >= W))
    __trap();
  if (k + 1 < K && counts[i + 1] > 0) {
    const long long at = ((long long)z * H + y) * W + x;
    const long long next =
        ((long long)coords[3 * i + 3] * H + coords[3 * i + 4]) * W +
        coords[3 * i + 5];
    if (!live || at >= next) __trap();
  }
}

// coords (B, K, 3) zyx, counts (B, K) -> occ (B, D, H, W): the row k of
// the live voxel at each cell, -1 elsewhere. Each block owns kOccCells
// consecutive cells of frame blockIdx.y: warps 0-1 find the rows that land
// there by a search of the frame's ascending cell ids (sorted_ids.cuh),
// the other warps check an equal share of all B * K rows against the
// contract, the block marks its rows in shared memory and stores every
// cell once, 16 bytes a store where the frame's cells are a multiple of 4.
__global__ void __launch_bounds__(kThreads)
occupancy_kernel(const int* __restrict__ coords,
                 const int* __restrict__ counts, int* __restrict__ occ,
                 int K, int D, int H, int W) {
  __shared__ __align__(16) int row_of[kOccCells];
  __shared__ int range[2];
  const int n = D * H * W;
  const int b = blockIdx.y;
  const int base = blockIdx.x * kOccCells;
  const int cells = min(kOccCells, n - base);
  const TableIds id{coords + (size_t)b * K * 3, counts + (size_t)b * K, H, W,
                    n};
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int at = warp_lower_bound(id, K, base + (warp ? cells : 0));
    if ((threadIdx.x & 31) == 0) range[warp] = at;
  } else {
    const long long total = (long long)gridDim.y * K;
    const long long blocks = (long long)gridDim.x * gridDim.y;
    const long long per = (total + blocks - 1) / blocks;
    const long long first =
        ((long long)blockIdx.y * gridDim.x + blockIdx.x) * per;
    const long long last = min(first + per, total);
    for (long long i = first + (int)threadIdx.x - 64; i < last;
         i += kThreads - 64)
      check_row(coords, counts, i, (int)(i % K), K, D, H, W);
  }
  for (int r = threadIdx.x; r < kOccCells; r += kThreads) row_of[r] = -1;
  __syncthreads();
  for (int s = range[0] + threadIdx.x; s < range[1]; s += kThreads) {
    const int r = id(s) - base;  // in [0, cells) for ascending ids
    if (r >= 0 && r < cells) row_of[r] = s;
  }
  __syncthreads();
  int* dst = occ + (size_t)b * n + base;
  if ((n & 3) == 0) {
    const int4* src = reinterpret_cast<const int4*>(row_of);
    for (int r = threadIdx.x; r < cells / 4; r += kThreads)
      reinterpret_cast<int4*>(dst)[r] = src[r];
  } else {
    for (int r = threadIdx.x; r < cells; r += kThreads) dst[r] = row_of[r];
  }
}

// dout (B, Do, H, wloc, chunks) -> dvals (B, K, 27, chunks)
__global__ void __launch_bounds__(kThreads)
sparse_conv_grad_kernel(const uint4* __restrict__ dout,
                        const int* __restrict__ coords,  // (B, K, 3) zyx
                        const int* __restrict__ counts,  // (B, K)
                        uint4* __restrict__ dvals,
                        int B, int K, int Do, int H, int wloc, int stride_d,
                        int pad_d, int x0, int chunks) {
  const size_t total = (size_t)B * K * 27 * chunks;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const size_t r = i / chunks;  // (b * K + k) * 27 + o
    const int c = (int)(i - r * chunks);
    const size_t bk = r / 27;
    const int o = (int)(r - bk * 27);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (counts[bk] > 0) {
      const int num = coords[bk * 3] + pad_d - o / 9;
      const int oz = num / stride_d;
      const int oy = coords[bk * 3 + 1] + 1 - (o / 3) % 3;
      const int ox = coords[bk * 3 + 2] + 1 - o % 3 - x0;
      if (num >= 0 && num - oz * stride_d == 0 && oz < Do && oy >= 0 &&
          oy < H && ox >= 0 && ox < wloc) {
        const size_t b = bk / K;
        v = dout[(((b * Do + oz) * H + oy) * wloc + ox) * chunks + c];
      }
    }
    dvals[i] = v;
  }
}

// the persistent grid of a forward kernel: its resident blocks on every
// SM of the current device (looked up once a device)
template <typename T>
int resident_blocks(int* blocks) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sparse_conv_fwd_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return 0;
}

template <typename T>
int launch_fwd(const void* vals, const void* occ, const void* bias, void* out,
               void* next, int B, int K, int D, int H, int W, int Do,
               int stride_d, int pad_d, int x0, int wloc, int channels,
               int relu, void* stream) {
  Geometry g;
  g.K = K;
  g.D = D;
  g.H = H;
  g.W = W;
  g.Do = Do;
  g.stride_d = stride_d;
  g.pad_d = pad_d;
  g.x0 = x0;
  g.wloc = wloc;
  g.chunks = channels / Chunk<T>::kPer;
  g.tiles_x = (wloc + kTileX - 1) / kTileX;
  g.tiles_y = (H + kTileY - 1) / kTileY;
  g.tiles = B * Do * g.tiles_y * g.tiles_x;
  int blocks = 0;
  int err = resident_blocks<T>(&blocks);
  if (err != 0) return err;
  if (blocks > g.tiles) blocks = g.tiles;
  err = (int)cudaMemsetAsync(next, 0, sizeof(int), (cudaStream_t)stream);
  if (err != 0) return err;
  sparse_conv_fwd_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)vals, (const int*)occ, (const float*)bias, (uint4*)out,
      (int*)next, g, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// coords (B, K, 3) int32, counts (B, K) int32 -> occ (B, D, H, W) int32,
// every cell written by one launch; D * H * W < 2**31, B < 65536.
extern "C" int occupancy_map_launch(const void* coords, const void* counts,
                                    void* occ, int B, int K, int D, int H,
                                    int W, void* stream) {
  const dim3 grid((D * H * W + kOccCells - 1) / kOccCells, B);
  occupancy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)coords, (const int*)counts, (int*)occ, K, D, H, W);
  return (int)cudaGetLastError();
}

// vals (B, K, 27, C) bf16, occ (B, D, H, W) int32, bias (C,) f32 ->
// out (B, Do, H, wloc, C) bf16, ReLU'd where relu != 0; C / 8 divides 256.
// next: one int32 of scratch, the tile counter (zeroed here).
extern "C" int sparse_conv_fwd_launch(const void* vals, const void* occ,
                                      const void* bias, void* out, void* next,
                                      int B, int K, int D, int H, int W,
                                      int Do, int stride_d, int pad_d, int x0,
                                      int wloc, int channels, int relu,
                                      void* stream) {
  return launch_fwd<__nv_bfloat16>(vals, occ, bias, out, next, B, K, D, H, W,
                                   Do, stride_d, pad_d, x0, wloc, channels,
                                   relu, stream);
}

// The same with vals and out f32; C / 4 divides 256.
extern "C" int sparse_conv_fwd_f32_launch(const void* vals, const void* occ,
                                          const void* bias, void* out,
                                          void* next, int B, int K, int D,
                                          int H, int W, int Do, int stride_d,
                                          int pad_d, int x0, int wloc,
                                          int channels, int relu,
                                          void* stream) {
  return launch_fwd<float>(vals, occ, bias, out, next, B, K, D, H, W, Do,
                           stride_d, pad_d, x0, wloc, channels, relu, stream);
}

// info[0..3] of the bf16 (f32 == 0) or f32 forward kernel:
// csrc/kernel_info.cuh
extern "C" int sparse_conv_fwd_info(int* info, int f32) {
  return f32 ? kernel_attributes(sparse_conv_fwd_kernel<float>, kThreads, info)
             : kernel_attributes(sparse_conv_fwd_kernel<__nv_bfloat16>,
                                 kThreads, info);
}

// dout (B, Do, H, wloc, C), coords (B, K, 3) int32, counts (B, K) int32 ->
// dvals (B, K, 27, C) of dout's type; a row of C is `chunks` 16-byte chunks.
extern "C" int sparse_conv_grad_launch(const void* dout, const void* coords,
                                       const void* counts, void* dvals, int B,
                                       int K, int Do, int H, int wloc,
                                       int stride_d, int pad_d, int x0,
                                       int chunks, void* stream) {
  const size_t total = (size_t)B * K * 27 * chunks;
  const size_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1u << 20) ? want : (1u << 20));
  sparse_conv_grad_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)dout, (const int*)coords, (const int*)counts,
      (uint4*)dvals, B, K, Do, H, wloc, stride_d, pad_d, x0, chunks);
  return (int)cudaGetLastError();
}
