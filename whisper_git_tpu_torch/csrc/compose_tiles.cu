// K3: the compose kernel of the layer-image path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_git_tpu/render/pallas_compose.py::compose_tiles and its XLA
// epilogue pallas_raster.py::assemble_u8.
//
// What it computes: per 64x128 output tile, start from the opaque
// background and blend a z-ordered list of ops with a premultiplied `over`
// in f32, then quantize to the interleaved (H, W, 4) u8 frame, alpha 255:
//   img   a cached chrome layer, (h, w, 4) i16 fixed point at 1/32767, cut
//         to a tile-aligned rect at tile offset (ty0, tx0); tiles outside
//         the rect skip it;
//   slab  a cached scroll slab, (slab_h, w, 4) i16: the frame shows its
//         rows [start, start + height), start read from `starts` (the only
//         value that changes on a pure scroll), masked to the window's y
//         clip on pixel centres (the x clip is baked into its pixels);
//   dyni  a volatile shape tail rasterized here with `shape_step` over
//         per-frame bins of a sub-grid of tile columns [c0, c0 + ts), its
//         tables translated to sub-grid-local x;
//   dyn   a volatile glyph or image tail pre-rendered by the blocks
//         kernel, (h, w, 4) f32 over the same sub-grid columns.
//
// What bounds it on this card: bytes. A frame reads 8 B a pixel of every
// covered layer tile and slab crop and writes 4 B a pixel; the arithmetic
// is four multiply-adds a pixel a layer plus the few inline shapes.
//
// What the design does about it:
//  * layers are interleaved RGBA i16, one 8-byte load a pixel, a warp
//    reading 256 contiguous bytes of one row; a slab crop is a row offset
//    (no realignment pass), and a tile outside an op's rect or column
//    range reads nothing, so traffic follows ink, not layer count;
//  * one CTA a tile, 512 threads x 16 pixels, RGB in registers across the
//    whole op list, one write of the frame with the ragged edge cropped;
//  * the op list depends on the scene, so it is a flat array of descriptors
//    in device memory that every thread of the CTA reads alike (as the
//    blocks kernel does); reads are bounded by each layer's pixel extent;
//  * the inline tail is `shape_step` of raster_steps.cuh, the same code as
//    in the two rasterizers, on a copy of the column centre shifted to the
//    sub-grid; the library is built with --fmad=false, so `src + fb * (1 -
//    a)` is a multiply and an add as in the plain PyTorch version.
#include <cuda_runtime.h>

#include "raster_steps.cuh"

namespace raster {

constexpr int OP_IMG = 0;
constexpr int OP_SLAB = 1;
constexpr int OP_DYNI = 2;
constexpr int OP_DYN = 3;
constexpr float I16_INV = (float)(1.0 / 32767.0);

// One op. Mirrored by _OP_DESC in render/compose_kernel.py.
struct ComposeOp {
  const void* src;      // img, slab: (h, w, 4) i16 | dyn: (h, w, 4) f32 |
                        // dyni: shapes (cap, 16) f32
  const float* clips;   // dyni: shape clips (cap, 4)
  const int* bins;      // dyni: (tiles_y * ts, k), -1 = empty slot
  const int* counts;    // dyni: (tiles_y * ts,) slots to walk
  int kind;
  int h, w;             // img, slab, dyn: pixel extent of src
  int ty0, tx0;         // img: tile offset of the rect | dyni, dyn: tx0 = c0
  int ts;               // dyni, dyn: tile columns of the sub-grid
  int k;                // dyni: bins row width
  int slab;             // slab: index into starts
  float cy0, cy1;       // slab: y clip on pixel centres, inclusive
};

// Mirrored by _ComposeParams in render/compose_kernel.py.
struct ComposeParams {
  const ComposeOp* ops;   // device memory, z order
  int n_ops;
  int n_starts;
  const int* starts;      // (n_starts,) first slab row of the frame
  float bg_r, bg_g, bg_b;
  int tiles_x, tiles_y, height, width;
  unsigned char* out;     // (height, width, 4) u8
};

// Premultiplied source over the accumulator (RGB only: the frame is opaque).
__device__ __forceinline__ void over_src(Pixels& f, int i, float sr, float sg,
                                         float sb, float sa) {
  const float inv = 1.0f - sa;
  f.r[i] = sr + f.r[i] * inv;
  f.g[i] = sg + f.g[i] * inv;
  f.b[i] = sb + f.b[i] * inv;
}

__device__ __forceinline__ void over_i16(Pixels& f, int i, short4 s) {
  over_src(f, i, (float)s.x * I16_INV, (float)s.y * I16_INV,
           (float)s.z * I16_INV, (float)s.w * I16_INV);
}

__global__ void __launch_bounds__(THREADS, 1)
    compose_tiles_kernel(const __grid_constant__ ComposeParams p) {
  const int t = blockIdx.x;
  const int ti = t / p.tiles_x, tj = t % p.tiles_x;
  Pixels f;
  const int col = threadIdx.x % TILE_W;
  f.row0 = threadIdx.x / TILE_W;
  const int ox = tj * TILE_W;
  const int oy = ti * TILE_H;
  const float px = ((float)col + (float)ox) + 0.5f;
  f.px = px;
  f.oy = (float)oy;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    f.r[i] = p.bg_r;
    f.g[i] = p.bg_g;
    f.b[i] = p.bg_b;
    f.a[i] = 1.0f;
  }

#pragma unroll 1
  for (int b = 0; b < p.n_ops; ++b) {
    const ComposeOp d = p.ops[b];
    if (d.kind == OP_IMG) {
      const int ly0 = (ti - d.ty0) * TILE_H;
      const int lx0 = (tj - d.tx0) * TILE_W;
      if (ly0 < 0 || lx0 < 0 || ly0 >= d.h || lx0 >= d.w) continue;
      const int lx = lx0 + col;
      if (lx >= d.w) continue;
      const short4* src = reinterpret_cast<const short4*>(d.src);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int ly = ly0 + f.row0 + i * ROW_STRIDE;
        if (ly < d.h) over_i16(f, i, src[(size_t)ly * d.w + lx]);
      }
    } else if (d.kind == OP_SLAB) {
      const int lx = ox + col;
      if (lx >= d.w || d.slab >= p.n_starts) continue;
      const int start = p.starts[d.slab];
      const short4* src = reinterpret_cast<const short4*>(d.src);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float py = f.py(i);
        const int sy = start + oy + f.row0 + i * ROW_STRIDE;
        // Outside the y clip the source and its alpha are multiplied by 0,
        // and `0 + fb * (1 - 0)` leaves the pixel as it is.
        if (py >= d.cy0 && py <= d.cy1 && sy >= 0 && sy < d.h) {
          over_i16(f, i, src[(size_t)sy * d.w + lx]);
        }
      }
    } else if (d.kind == OP_DYNI) {
      if (tj < d.tx0 || tj >= d.tx0 + d.ts || ti >= p.tiles_y) continue;
      const int tsub = ti * d.ts + (tj - d.tx0);
      const int n = min(d.counts[tsub], d.k);
      const int* row = d.bins + (size_t)tsub * d.k;
      const float* shapes = reinterpret_cast<const float*>(d.src);
      // The tail's tables and bins live in the sub-grid's coordinates.
      f.px = px - (float)(d.tx0 * TILE_W);
#pragma unroll 1
      for (int k = 0; k < n; ++k) {
        const int idx = row[k];
        if (idx < 0) continue;
        shape_step(f, shapes + (size_t)idx * 16, d.clips + (size_t)idx * 4);
      }
      f.px = px;
    } else {
      const int lx0 = (tj - d.tx0) * TILE_W;
      if (tj < d.tx0 || tj >= d.tx0 + d.ts || lx0 >= d.w || oy >= d.h) {
        continue;
      }
      const int lx = lx0 + col;
      if (lx >= d.w) continue;
      const float4* src = reinterpret_cast<const float4*>(d.src);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int ly = oy + f.row0 + i * ROW_STRIDE;
        if (ly < d.h) {
          const float4 s = src[(size_t)ly * d.w + lx];
          over_src(f, i, s.x, s.y, s.z, s.w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) f.a[i] = 1.0f;   // opaque: alpha 255
  store_u8(f, ox + col, oy, p.out, p.height, p.width);
}

}  // namespace raster

extern "C" {

// Launch one CTA per tile on `stream`, on the calling thread's current
// device. Returns cudaGetLastError(): a launch the runtime refused never
// runs, and a synchronize would not say.
int compose_tiles_launch(const raster::ComposeParams* params, int n_tiles,
                         void* stream) {
  raster::compose_tiles_kernel<<<n_tiles, raster::THREADS, 0,
                                 (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

const char* compose_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int compose_tiles_params_size() { return (int)sizeof(raster::ComposeParams); }

int compose_tiles_desc_size() { return (int)sizeof(raster::ComposeOp); }

}  // extern "C"
