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
//         rows [start, start + height), start read as an i16 of the frame
//         blob (the only value that changes on a pure scroll), masked to
//         the window's y clip on pixel centres (the x clip is baked into
//         its pixels);
//   dyni  a volatile shape tail rasterized here with `shape_step` over
//         per-frame bins of a sub-grid of tile columns [c0, c0 + ts), read
//         from the frame blob as the host packed it: i16 tables and bins,
//         each value de-quantized here and moved to sub-grid-local x;
//   dyn   a volatile glyph or image tail pre-rendered by the blocks
//         kernel, (h, w, 4) f32 over the same sub-grid columns.
//
// What bounds it on this card: bytes. A frame reads 8 B a pixel of every
// covered layer tile and slab crop and writes 4 B a pixel; the arithmetic
// is four multiply-adds a pixel a layer plus the few inline shapes. The
// kernel is short (tens of microseconds), so what it waited for was its
// slowest CTA, a tile under both slabs and the chrome, walking its ops one
// load latency after another, and before that its own descriptors' upload.
//
// What the design does about it:
//  * layers are interleaved RGBA i16; a thread owns two neighbouring pixels
//    of a row and loads both with one 16-byte load (two 8-byte loads where
//    a layer's width is odd), a warp reading 512 contiguous bytes; a slab
//    crop is a row offset (no realignment pass), and a CTA outside an op's
//    rect or column range reads nothing, so traffic follows ink, not layer
//    count;
//  * a CTA owns a strip of rows of a tile, 128 threads (8 rows: eight CTAs
//    a tile, 1040 a 1280x800 frame, several resident on an SM), so one
//    CTA's stores overlap another's loads and the tiles under every layer
//    spread over more SMs; RGB stays in registers across the whole op list,
//    one write of the frame, 8 bytes a thread a row, the ragged edge
//    cropped;
//  * the op list is walked one op ahead: the loads of op b + 1 are started
//    before op b is blended, so a CTA under five layers waits for about one
//    load latency, not five. What an op does not cover is fetched as zeros,
//    a transparent source, whose blend `0 + fb * (1 - 0)` is the identity;
//  * the op list depends on the scene, and rides in the launch: up to
//    MAX_INLINE_OPS descriptors by value in the parameter block, read from
//    the parameter space by every thread alike (no allocation, no upload,
//    no wait); a longer list is a flat array in device memory, as before;
//    reads are bounded by each layer's pixel extent;
//  * a slice of a device mesh launches the tile rows [row0, row0 + n) of
//    the frame and writes them from the top of its output; every
//    coordinate stays the frame's (a layer's rect, a slab's start, a
//    tail's rows), and the rows a mesh pads the grid with are never
//    launched;
//  * the inline tail is `shape_step` of raster_steps.cuh, the same code as
//    in the two rasterizers, once for each of the thread's two columns, on
//    column centres shifted to the sub-grid, with the command's extent in
//    the same shifted coordinates; the library is built with --fmad=false,
//    so `src + fb * (1 - a)` is a multiply and an add as in the plain
//    PyTorch version;
//  * the frame blob is the kernel's input as the host uploaded it, so no
//    pass over it runs before the launch: a tail command's 16 + 4 values
//    are loaded as i16 and multiplied by the reciprocal of their column's
//    scale, every scale a power of two, so the product is exact; the move
//    to the sub-grid subtracts a multiple of TILE_W from values on a 1/8 px
//    grid, exact too. A command's values are those the host's de-quantize
//    and translate gave, bit for bit. A CTA's threads share one tile, so
//    one bins row and every command in it: twenty threads decode a command
//    into shared memory, a value each, and all read it by broadcast (a
//    command decoded in every thread's registers spilled the variant with
//    2 rows a thread: 26 to 62 us on an H100 at the history view's frame).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "raster_steps.cuh"

namespace raster {

constexpr int OP_IMG = 0;
constexpr int OP_SLAB = 1;
constexpr int OP_DYNI = 2;
constexpr int OP_DYN = 3;
constexpr float I16_INV = (float)(1.0 / 32767.0);
constexpr int MAX_INLINE_OPS = 48;     // descriptors that ride in the launch
constexpr int COMPOSE_THREADS = 128;   // 64 pixel pairs across, 2 rows
constexpr int PAIRS = TILE_W / 2;

// One op. Mirrored by _OP_DESC in render/compose_kernel.py.
struct ComposeOp {
  const void* src;      // img, slab: (h, w, 4) i16 | dyn: (h, w, 4) f32
  int kind;
  int h, w;             // img, slab, dyn: pixel extent of src
  int ty0, tx0;         // img: tile offset of the rect | dyni, dyn: tx0 = c0
  int ts;               // dyni, dyn: tile columns of the sub-grid
  int k;                // dyni: bins row width
  int slab;             // slab: index into the blob's starts
  float cy0, cy1;       // slab: y clip on pixel centres, inclusive
  // dyni: element offsets into the blob of the tail's shapes (cap, 16),
  // clips (cap, 4) and bins (tiles_y * ts, k), -1 an empty slot, a row's
  // entries first
  int shapes, clips, bins;
};

// Mirrored by _ComposeParams in render/compose_kernel.py.
struct ComposeParams {
  const ComposeOp* ops;   // device memory, z order; read when
  int n_ops;              // n_ops > MAX_INLINE_OPS
  int n_starts;
  const short* blob;      // the frame's i16 blob
  int starts;             // its offset of the (n_starts,) first slab rows
  float bg_r, bg_g, bg_b;
  int tiles_x, tiles_y, height, width;
  int row0;               // the first tile row launched
  unsigned char* out;     // the u8 frame's rows from row0 * TILE_H on, as
                          // many as were launched: (rows, width, 4)
  ComposeOp inline_ops[MAX_INLINE_OPS];
};

// Premultiplied source over the accumulator (RGB only: the frame is opaque).
template <class PX>
__device__ __forceinline__ void over_src(PX& f, int i, float sr, float sg,
                                         float sb, float sa) {
  const float inv = 1.0f - sa;
  f.r[i] = sr + f.r[i] * inv;
  f.g[i] = sg + f.g[i] * inv;
  f.b[i] = sb + f.b[i] * inv;
}

// Whether pixel pairs of an (h, w, 4) i16 layer at even columns lie on
// 16-byte addresses in every row.
__device__ __forceinline__ bool pair_aligned(const void* src, int w) {
  return (w & 1) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

// Op `b` of the list, by value: from the parameter space where the list
// rides in the launch, else from the array in device memory.
__device__ __forceinline__ ComposeOp op_at(const ComposeParams& p, int b) {
  if (p.n_ops <= MAX_INLINE_OPS) return p.inline_ops[b];
  return p.ops[b];
}

// What an "img" or "slab" op brings to this thread's pixels: for each of its
// rows the pixel pair (x: r, g of the even column in 16 bits each, y: b, a;
// z, w: the odd column), all zero, which is transparent, wherever the op
// does not cover the pixel. Blending a transparent source computes
// `0 + fb * (1 - 0)` and leaves the accumulator as it is, so nothing else
// has to remember what was covered.
template <int N_ROWS>
struct Fetched {
  int4 v[N_ROWS];
  bool any;   // false: the op is of another kind, or misses every pixel
};

// This thread's place in the frame.
struct Place {
  int ti, tj;       // tile row and column
  int oy;           // first row of the CTA's strip, frame px
  int strip_y;      // the same inside the tile
  int ox, col;      // tile origin x; this thread's even column in the tile
  int row0;         // this thread's first row below oy
};

// Start the loads of op `d` for this thread's rows. Nothing here waits for
// them: the caller fetches the next op before it blends the current one.
template <int N_ROWS>
__device__ __forceinline__ void fetch(const ComposeOp& d,
                                      const ComposeParams& p,
                                      const Place& at, Fetched<N_ROWS>& out) {
  out.any = false;
  const int h = d.h, w = d.w;
  int lx, y0;
  float cy0 = -__int_as_float(0x7f800000), cy1 = __int_as_float(0x7f800000);
  if (d.kind == OP_IMG) {
    lx = (at.tj - d.tx0) * TILE_W + at.col;
    y0 = (at.ti - d.ty0) * TILE_H + at.strip_y;
    if (at.ti < d.ty0 || at.tj < d.tx0 || y0 >= h || lx >= w) return;
  } else if (d.kind == OP_SLAB) {
    lx = at.ox + at.col;
    if (lx >= w || d.slab >= p.n_starts) return;
    y0 = (int)__ldg(p.blob + p.starts + d.slab) + at.oy;
    cy0 = d.cy0;
    cy1 = d.cy1;
  } else {
    return;
  }
  out.any = true;
  const short4* src = reinterpret_cast<const short4*>(d.src);
  const bool vec = pair_aligned(src, w), has1 = lx + 1 < w;
#pragma unroll
  for (int i = 0; i < N_ROWS; ++i) {
    const int r = at.row0 + i * 2;
    const float py = ((float)(r + at.oy)) + 0.5f;
    const int sy = y0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    // Outside a slab's y clip the source and its alpha are multiplied by 0:
    // transparent too.
    if (py >= cy0 && py <= cy1 && sy >= 0 && sy < h) {
      const short4* row = src + (size_t)sy * w + lx;
      if (vec) {
        v = __ldg(reinterpret_cast<const int4*>(row));
      } else {
        const int2 a = __ldg(reinterpret_cast<const int2*>(row));
        v.x = a.x;
        v.y = a.y;
        if (has1) {
          const int2 c = __ldg(reinterpret_cast<const int2*>(row + 1));
          v.z = c.x;
          v.w = c.y;
        }
      }
    }
    out.v[i] = v;
  }
}

// One i16 pixel in two 32-bit words over pixel i of f.
template <class PX>
__device__ __forceinline__ void over_i16(PX& f, int i, int rg, int ba) {
  over_src(f, i, (float)(short)(rg & 0xffff) * I16_INV,
           (float)(short)(rg >> 16) * I16_INV,
           (float)(short)(ba & 0xffff) * I16_INV,
           (float)(short)(ba >> 16) * I16_INV);
}

// The rows a thread owns in the launch (a CTA twice as many), the fastest of
// 2, 4 and 8 measured on an H100.
constexpr int COMPOSE_ROWS = 4;

// N_ROWS rows a thread, two row lanes: a CTA owns 2 * N_ROWS rows of a tile.
template <int N_ROWS>
__global__ void __launch_bounds__(COMPOSE_THREADS,
                                  N_ROWS <= 2 ? 6 : N_ROWS <= 4 ? 4 : 2)
    compose_tiles_kernel(const __grid_constant__ ComposeParams p) {
  using PX = PixelsT<N_ROWS, 2>;
  __shared__ float s_cmd[20];   // a tail command's values, then its clip
  constexpr int STRIP_H = 2 * N_ROWS;
  constexpr int STRIPS = TILE_H / STRIP_H;
  const int t = blockIdx.x / STRIPS, q = blockIdx.x % STRIPS;
  Place at;
  at.ti = p.row0 + t / p.tiles_x;
  at.tj = t % p.tiles_x;
  at.col = 2 * (threadIdx.x % PAIRS);
  at.row0 = threadIdx.x / PAIRS;
  at.ox = at.tj * TILE_W;
  at.strip_y = q * STRIP_H;
  at.oy = at.ti * TILE_H + at.strip_y;
  const int ti = at.ti, tj = at.tj, col = at.col, row0 = at.row0;
  const int ox = at.ox, oy = at.oy;
  const float px0 = ((float)col + (float)ox) + 0.5f;
  const float px1 = ((float)(col + 1) + (float)ox) + 0.5f;
  PX f0, f1;   // the even column, the odd column
  f0.row0 = f1.row0 = row0;
  f0.px = px0;
  f1.px = px1;
  f0.oy = f1.oy = (float)oy;
#pragma unroll
  for (int i = 0; i < N_ROWS; ++i) {
    f0.r[i] = f1.r[i] = p.bg_r;
    f0.g[i] = f1.g[i] = p.bg_g;
    f0.b[i] = f1.b[i] = p.bg_b;
    f0.a[i] = f1.a[i] = 1.0f;
  }

  // The op list in z order, one op ahead: the next op's layer is on its way
  // while this one is blended. Only the kinds are carried from op to op; a
  // tail, which is rare, reads its descriptor again.
  const int n_ops = p.n_ops;
  Fetched<N_ROWS> cur, nxt;
  cur.any = false;
  int kind = -1;
  if (n_ops > 0) {
    const ComposeOp d0 = op_at(p, 0);
    kind = d0.kind;
    fetch(d0, p, at, cur);
  }
#pragma unroll 1
  for (int b = 0; b < n_ops; ++b) {
    int kind_nxt = -1;
    nxt.any = false;
    if (b + 1 < n_ops) {
      const ComposeOp d_nxt = op_at(p, b + 1);
      kind_nxt = d_nxt.kind;
      fetch(d_nxt, p, at, nxt);
    }
    if (kind == OP_IMG || kind == OP_SLAB) {
      if (cur.any) {
#pragma unroll
        for (int i = 0; i < N_ROWS; ++i) {
          over_i16(f0, i, cur.v[i].x, cur.v[i].y);
          over_i16(f1, i, cur.v[i].z, cur.v[i].w);
        }
      }
    } else if (kind == OP_DYNI) {
      const ComposeOp d = op_at(p, b);
      if (tj >= d.tx0 && tj < d.tx0 + d.ts && ti < p.tiles_y) {
        const int tsub = ti * d.ts + (tj - d.tx0);
        const short* row = p.blob + d.bins + (size_t)tsub * d.k;
        // The tail's bins live in the sub-grid's coordinates; its tables
        // are moved there as they are read, and so is each command's
        // extent.
        const float shift = (float)(d.tx0 * TILE_W);
        f0.px = px0 - shift;
        f1.px = px1 - shift;
#pragma unroll 1
        for (int k = 0; k < d.k; ++k) {
          const int idx = __ldg(row + k);
          if (idx < 0) break;   // the host packs a row's entries first
          // Twenty of the CTA's threads decode the command, a value each.
          __syncthreads();      // the last command's values are read
          const int j = threadIdx.x;
          if (j < 20) {
            const short* cmd = p.blob + d.shapes + (size_t)idx * 16;
            float v = j < 16
                ? (float)__ldg(cmd + j) * SHAPE_INV[j]
                : (float)__ldg(p.blob + d.clips + (size_t)idx * 4 + j - 16)
                      * CLIP_INV;
            // A capsule (type 1) moves both end points, a rect its origin.
            if (j == 1 || j == 16 || j == 18
                || (j == 3 && (float)__ldg(cmd) * SHAPE_INV[0] == 1.0f)) {
              v -= shift;
            }
            s_cmd[j] = v;
          }
          __syncthreads();
          const Extent e = command_extent(0, s_cmd, s_cmd + 16);
          shape_step(f0, s_cmd, s_cmd + 16, e);
          shape_step(f1, s_cmd, s_cmd + 16, e);
        }
        f0.px = px0;
        f1.px = px1;
      }
    } else {
      const ComposeOp d = op_at(p, b);
      const int lx = (tj - d.tx0) * TILE_W + col;
      const int h = d.h, w = d.w;
      if (tj >= d.tx0 && tj < d.tx0 + d.ts && lx < w && oy < h) {
        const float4* src = reinterpret_cast<const float4*>(d.src);
        const bool has1 = lx + 1 < w;
#pragma unroll
        for (int i = 0; i < N_ROWS; ++i) {
          const int ly = oy + row0 + i * 2;
          if (ly < h) {
            const float4* pix = src + (size_t)ly * w + lx;
            const float4 s0 = __ldg(pix);
            over_src(f0, i, s0.x, s0.y, s0.z, s0.w);
            if (has1) {
              const float4 s1 = __ldg(pix + 1);
              over_src(f1, i, s1.x, s1.y, s1.z, s1.w);
            }
          }
        }
      }
    }
    kind = kind_nxt;
    cur = nxt;
  }

  // Quantize and store the pair, alpha 255: 8 bytes a thread a row where
  // the frame's width is even, the ragged edge cropped.
  const int x = ox + col;
  if (x >= p.width) return;
  const bool has1 = x + 1 < p.width, vec = (p.width & 1) == 0;
  uchar4* o4 = reinterpret_cast<uchar4*>(p.out);
  const int y_out0 = p.row0 * TILE_H;   // the output's first row
#pragma unroll
  for (int i = 0; i < N_ROWS; ++i) {
    const int y = oy + row0 + i * 2;
    if (y < p.height) {
      const uchar4 a = make_uchar4(quantize_u8(f0.r[i]), quantize_u8(f0.g[i]),
                                   quantize_u8(f0.b[i]), 255);
      const uchar4 c = make_uchar4(quantize_u8(f1.r[i]), quantize_u8(f1.g[i]),
                                   quantize_u8(f1.b[i]), 255);
      uchar4* at = o4 + (size_t)(y - y_out0) * p.width + x;
      if (vec) {
        uint2 v;
        v.x = (unsigned)a.x | (unsigned)a.y << 8 | (unsigned)a.z << 16
              | (unsigned)a.w << 24;
        v.y = (unsigned)c.x | (unsigned)c.y << 8 | (unsigned)c.z << 16
              | (unsigned)c.w << 24;
        *reinterpret_cast<uint2*>(at) = v;
      } else {
        at[0] = a;
        if (has1) at[1] = c;
      }
    }
  }
}

}  // namespace raster

extern "C" {

// Launch TILE_H / (2 * COMPOSE_ROWS) CTAs a tile for `n_tiles` tiles from
// the first of tile row `row0` on `stream`, on the calling thread's current
// device. Returns cudaGetLastError(): a launch the runtime refused never
// runs, and a synchronize would not say.
int compose_tiles_launch(const raster::ComposeParams* params, int n_tiles,
                         void* stream) {
  using namespace raster;
  compose_tiles_kernel<COMPOSE_ROWS>
      <<<n_tiles * (TILE_H / (2 * COMPOSE_ROWS)), COMPOSE_THREADS, 0,
         (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

const char* compose_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int compose_tiles_params_size() { return (int)sizeof(raster::ComposeParams); }

int compose_tiles_desc_size() { return (int)sizeof(raster::ComposeOp); }

int compose_tiles_inline_offset() {
  return (int)offsetof(raster::ComposeParams, inline_ops);
}

int compose_tiles_max_inline() { return raster::MAX_INLINE_OPS; }

}  // extern "C"
