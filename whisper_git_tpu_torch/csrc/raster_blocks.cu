// K2: the blocks rasterizer of the frame-cache path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_git_tpu/render/pallas_raster.py::render_tiles_blocks and its XLA
// epilogues `assemble_planar` (u8 frame) and `assemble_f32` (f32 layer), and
// for a cached layer the quantize pass that followed them.
//
// What it computes: per 64x128 tile, start from the background (alpha 1)
// or from a transparent canvas, then walk a z-ordered list of blocks. A
// block is one command class with its own tables, a bins table (T, k) and
// per-tile bounds: the tile composites slots [lo[t], hi[t]) of its bins
// row, skipping -1. Chrome z-segments share one bins table and differ only
// in their bounds; window blocks bring tables shifted for this frame and
// bins gathered from the scroll offset; the volatile tail comes last.
//
// What bounds it on this card: operations, the step functions' scalar f32
// arithmetic on the pixels a command inks (a division and a `sqrtf` a pixel,
// no contracted multiply-add), run by warps that a narrow glyph fills
// to a third. Device-memory traffic is the command tables, the bins and
// bounds once, and the output once. Before this design most of the
// arithmetic multiplied by 0 (a glyph inks about 10x16 of a tile's 8192
// pixels), a tile's commands were fetched one by one through two dependent
// loads, and a launch lasted as long as its busiest tile on one SM.
//
// What the design does about it:
//  * work follows ink: every command carries its extent (`command_extent`
//    of raster_steps.cuh), and the step functions skip the warps and the
//    rows it cannot ink, which changes no bit;
//  * a CTA owns a small unit of a tile, 32 columns by 16 rows (128 threads
//    x 4 pixels, 16 CTAs a tile, 2080 a 1280x800 frame, eight resident on
//    an SM at 64 registers), so a busy tile spreads over many SMs, the
//    card's schedulers even out what the tiles do not, and the unrolled
//    step functions stay small; the unit is a template parameter and
//    `chip_smoke.py` times the shapes compiled below (whole-tile columns
//    of 32 to 128 took 1.6 to 1.7 times as long);
//  * commands are staged in shared memory: 128 threads each take one slot of
//    the tile's bins row, load the command's extent, drop it at once if it
//    misses this unit, and the survivors are written in z order (a ballot
//    and a prefix) into a buffer of 192 commands; the compositing loop then
//    reads shared memory by broadcast and has no global load in its chain.
//    The next pass's bins slot is loaded before the current pass is staged
//    or the buffer is composited, and the bounds of every block are read
//    once, up front;
//  * a block is a loop range, not a launch, and its descriptor rides in the
//    launch: up to MAX_INLINE_BLOCKS of them by value in the parameter
//    block (no allocation, no upload, no wait); a longer list is a flat
//    array in device memory, as before;
//  * three epilogues chosen by the caller: the interleaved (H, W, 4) u8 frame
//    quantized here, the f32 premultiplied layer, or the i16 layer at
//    1/32767 that the compose kernel reads, written once; and a tile rect:
//    only its tiles are launched and the output is the cropped layer. None
//    writes past the output's ragged edge.
#include <cuda_runtime.h>

#include <cstddef>

#include "raster_steps.cuh"

namespace raster {

constexpr int MAX_INLINE_BLOCKS = 64;   // descriptors that ride in the launch
constexpr int STAGE_PASS = 128;         // bins slots examined at a time
constexpr int STAGE_CAP = 192;          // commands the shared buffer holds

// One block. Mirrored by _BLOCK_DESC in render/blocks_kernel.py.
struct BlockDesc {
  const float* t0;   // shapes (N,16) | glyphs (N,8)       | images (N,8)
  const float* t1;   // shape_clips   | glyph_colors (N,4) | image_clips
  const float* t2;   // unused        | glyph_clips (N,4)  | unused
  const int* bins;   // (T, k), -1 = empty slot
  const int* lo;     // (T,) first slot, or null for 0
  const int* hi;     // (T,) one past the last slot
  int cls;           // 0 shapes, 1 glyphs, 2 images
  int k;
};

constexpr int OUT_U8 = 0;    // over the background, the u8 frame
constexpr int OUT_F32 = 1;   // over a transparent canvas, the f32 layer
constexpr int OUT_I16 = 2;   // the same layer, i16 fixed point at 1/32767

// Mirrored by _BlocksParams in render/blocks_kernel.py.
struct BlocksParams {
  const BlockDesc* blocks;           // device memory, z order; read when
  int n_blocks;                      // n_blocks > MAX_INLINE_BLOCKS
  int out_mode;
  const unsigned char* font_tex;     // (font_h, font_w) SDF, 128 = edge
  int font_h, font_w;
  const unsigned char* image_atlas;  // (atlas_h, atlas_w, 4) rgba
  int atlas_h, atlas_w;
  float bg_r, bg_g, bg_b;
  int tiles_x, tiles_y;              // the grid the bins were built over
  int ty0, tx0, rect_tx;             // the launched tile rect: origin, width
  int height, width;                 // pixel extent of out (the rect's)
  void* out;                         // (height, width, 4) u8, f32 or i16
  BlockDesc inline_blocks[MAX_INLINE_BLOCKS];
};

// One command in shared memory.
struct __align__(16) Staged {
  float t[16];     // shape: 16 columns | glyph: quad 8, colour 4 | image: 8
  float clip[4];
  Extent e;
  int cls;
  int pad[3];
};

// A pass of the staging: slots [s, s + STAGE_PASS) of block b's row, below
// hi. b == n_blocks: the walk is over.
struct Cursor {
  int b, s, hi;
};

// CTAs an SM should hold: as many as its 65536 registers allow at 128, 96
// or 64 registers a thread for 16, 8 or 4 rows a thread.
constexpr int min_ctas(int threads, int n_rows) {
  return 65536 / (threads * (n_rows >= 16 ? 128 : n_rows >= 8 ? 96 : 64));
}

// A CTA owns a unit of a tile: STRIP_W columns by ROW_STRIDE * N_ROWS rows,
// STRIP_W * ROW_STRIDE threads of N_ROWS pixels each. A warp holds 32
// neighbouring columns and every ROW_STRIDE-th row of the unit, so the warps
// of a unit share each command's rows evenly.
template <int STRIP_W, int N_ROWS>
__global__ void __launch_bounds__(STRIP_W * ROW_STRIDE,
                                  min_ctas(STRIP_W * ROW_STRIDE, N_ROWS))
    raster_blocks_kernel(const __grid_constant__ BlocksParams p) {
  using PX = PixelsT<N_ROWS, ROW_STRIDE>;
  constexpr int UNIT_H = ROW_STRIDE * N_ROWS;
  constexpr int SPLIT_X = TILE_W / STRIP_W, SPLIT_Y = TILE_H / UNIT_H;
  __shared__ Staged buf[STAGE_CAP];
  __shared__ int s_lo[MAX_INLINE_BLOCKS], s_hi[MAX_INLINE_BLOCKS];
  __shared__ int s_count[2][STAGE_PASS / 32];

  const int tid = threadIdx.x;
  const int local_tile = blockIdx.x / (SPLIT_X * SPLIT_Y);
  const int unit = blockIdx.x % (SPLIT_X * SPLIT_Y);
  const int strip = unit % SPLIT_X, band = unit / SPLIT_X;
  const int ty = p.ty0 + local_tile / p.rect_tx;
  const int tx = p.tx0 + local_tile % p.rect_tx;
  const int t = ty * p.tiles_x + tx;
  const int col = strip * STRIP_W + tid % STRIP_W;
  const int ox = tx * TILE_W, oy = ty * TILE_H + band * UNIT_H;
  PX f;
  f.row0 = tid / STRIP_W;
  f.px = ((float)col + (float)ox) + 0.5f;
  f.oy = (float)oy;
  const bool opaque = p.out_mode == OUT_U8;
#pragma unroll
  for (int i = 0; i < N_ROWS; ++i) {
    f.r[i] = opaque ? p.bg_r : 0.0f;
    f.g[i] = opaque ? p.bg_g : 0.0f;
    f.b[i] = opaque ? p.bg_b : 0.0f;
    f.a[i] = opaque ? 1.0f : 0.0f;
  }
  // The pixel centres this CTA owns, bounds inclusive.
  const float x_lo = ((float)(strip * STRIP_W) + (float)ox) + 0.5f;
  const float x_hi = ((float)(strip * STRIP_W + STRIP_W - 1) + (float)ox)
                     + 0.5f;
  const float y_lo = (float)oy + 0.5f;
  const float y_hi = ((float)(UNIT_H - 1) + (float)oy) + 0.5f;

  const int n_blocks = p.n_blocks;
  const bool inl = n_blocks <= MAX_INLINE_BLOCKS;
  const BlockDesc* blocks = inl ? p.inline_blocks : p.blocks;
  if (inl && tid < n_blocks) {
    const BlockDesc& d = blocks[tid];
    s_lo[tid] = d.lo ? max(d.lo[t], 0) : 0;
    s_hi[tid] = min(d.hi[t], d.k);
  }
  __syncthreads();

  // Move `c` on to the first pass that holds a slot, at or after (b, s).
  auto seek = [&](Cursor& c) {
    while (c.b < n_blocks && c.s >= c.hi) {
      if (++c.b == n_blocks) break;
      if (inl) {
        c.s = s_lo[c.b];
        c.hi = s_hi[c.b];
      } else {
        const BlockDesc& d = blocks[c.b];
        c.s = d.lo ? max(d.lo[t], 0) : 0;
        c.hi = min(d.hi[t], d.k);
      }
    }
  };
  // This thread's slot of pass `c`: a command index, or -1.
  auto slot = [&](const Cursor& c) {
    const int k = c.s + tid;
    if (c.b >= n_blocks || tid >= STAGE_PASS || k >= c.hi) return -1;
    const BlockDesc& d = blocks[c.b];
    return d.bins[(size_t)t * d.k + k];
  };

  Cursor cur = {-1, 0, 0};
  seek(cur);
  int idx = slot(cur);
  int n = 0, parity = 0;
#pragma unroll 1
  while (true) {
    const bool more = cur.b < n_blocks;
    Cursor nxt = cur;
    int idx_nxt = -1;
    if (more) {   // the next pass's slot is in flight from here on
      nxt.s += STAGE_PASS;
      seek(nxt);
      idx_nxt = slot(nxt);
    }
    if (!more || n + STAGE_PASS > STAGE_CAP) {
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const Staged& s = buf[j];
        if (s.cls == 0) {
          shape_step(f, s.t, s.clip, s.e);
        } else if (s.cls == 1) {
          glyph_step(f, s.t, s.t + 8, s.clip, s.e, p.font_tex, p.font_h,
                     p.font_w);
        } else {
          image_step(f, s.t, s.clip, s.e, p.image_atlas, p.atlas_h,
                     p.atlas_w);
        }
      }
      if (!more) break;
      __syncthreads();
      n = 0;
    }

    // Stage pass `cur`: each thread's command, if it can ink this unit.
    const BlockDesc& d = blocks[cur.b];
    const int cls = d.cls;
    const float* c = nullptr;
    const float* colour = nullptr;
    const float* clip = nullptr;
    Extent e;
    bool keep = false;
    if (idx >= 0) {
      if (cls == 0) {
        c = d.t0 + (size_t)idx * 16;
        clip = d.t1 + (size_t)idx * 4;
      } else if (cls == 1) {
        c = d.t0 + (size_t)idx * 8;
        colour = d.t1 + (size_t)idx * 4;
        clip = d.t2 + (size_t)idx * 4;
      } else {
        c = d.t0 + (size_t)idx * 8;
        clip = d.t1 + (size_t)idx * 4;
      }
      e = command_extent(cls, c, clip);
      keep = e.x1 >= x_lo && e.x0 <= x_hi && e.y1 >= y_lo && e.y0 <= y_hi;
    }
    // The survivors keep their z order: a ballot a warp, a prefix over the
    // staging warps' counts.
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    const int warp = tid / 32, lane = tid % 32;
    if (tid < STAGE_PASS && lane == 0) s_count[parity][warp] = __popc(ballot);
    __syncthreads();
    int base = n, total = 0;
#pragma unroll
    for (int w = 0; w < STAGE_PASS / 32; ++w) {
      const int cw = s_count[parity][w];
      if (w < warp) base += cw;
      total += cw;
    }
    if (keep) {
      Staged& s = buf[base + __popc(ballot & ((1u << lane) - 1u))];
      const int nc = cls == 0 ? 16 : 8;
      for (int j = 0; j < nc; ++j) s.t[j] = c[j];
      if (cls == 1) {
        for (int j = 0; j < 4; ++j) s.t[8 + j] = colour[j];
      }
      for (int j = 0; j < 4; ++j) s.clip[j] = clip[j];
      s.e = e;
      s.cls = cls;
    }
    n += total;
    parity ^= 1;
    cur = nxt;
    idx = idx_nxt;
  }

  const int x_out = ox + col - p.tx0 * TILE_W;
  const int oy_out = oy - p.ty0 * TILE_H;
  if (p.out_mode == OUT_U8) {
    store_u8(f, x_out, oy_out, (unsigned char*)p.out, p.height, p.width);
  } else if (p.out_mode == OUT_F32) {
    store_f32(f, x_out, oy_out, (float*)p.out, p.height, p.width);
  } else {
    store_i16(f, x_out, oy_out, (short*)p.out, p.height, p.width);
  }
}

}  // namespace raster

extern "C" {

// Launch the tiles of the rect in `params` on `stream`, on the calling
// thread's current device: a CTA a unit of `strip_w` columns by 4 * `rows`
// rows of a tile, (128 / strip_w) * (16 / rows) CTAs a tile; the pairs
// compiled are listed below. Returns cudaGetLastError(): a launch the
// runtime refused never runs, and a synchronize would not say.
int raster_blocks_launch(const raster::BlocksParams* params, int n_tiles,
                         int strip_w, int rows, void* stream) {
  using namespace raster;
  cudaStream_t s = (cudaStream_t)stream;
#define RASTER_BLOCKS_CASE(W, R)                                           \
  case (W) * 256 + (R):                                                    \
    raster_blocks_kernel<W, R>                                             \
        <<<n_tiles * (TILE_W / (W)) * (ROWS / (R)), (W) * ROW_STRIDE, 0,   \
           s>>>(*params);                                                  \
    break;
  switch (strip_w * 256 + rows) {
    RASTER_BLOCKS_CASE(32, 4)
    RASTER_BLOCKS_CASE(64, 4)
    RASTER_BLOCKS_CASE(32, 8)
    RASTER_BLOCKS_CASE(32, 16)
    RASTER_BLOCKS_CASE(128, 16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RASTER_BLOCKS_CASE
  return (int)cudaGetLastError();
}

const char* raster_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int raster_blocks_params_size() { return (int)sizeof(raster::BlocksParams); }

int raster_blocks_desc_size() { return (int)sizeof(raster::BlockDesc); }

int raster_blocks_inline_offset() {
  return (int)offsetof(raster::BlocksParams, inline_blocks);
}

int raster_blocks_max_inline() { return raster::MAX_INLINE_BLOCKS; }

}  // extern "C"
