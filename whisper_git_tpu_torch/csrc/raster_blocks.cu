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
// in their bounds. A scroll window and the volatile tail, the frame cache's
// per-frame inputs, come as the frame blob the host uploaded: a window block
// brings the window's cached tables in window coordinates and its pair bins
// (a row of them for every two tile rows of the window), and the kernel
// reads the window's uniform row from the blob, picks each tile's pair-bin
// row from the scroll offset and moves each command and cuts its clip as it
// stages it; a tail block points at the tail's i16 tables and bins in the
// blob, de-quantized as they are staged. So nothing runs between the blob's
// upload and the launch.
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
//  * a block's kind is uniform over a CTA, so resolving a window or a tail
//    is a branch per staged pass and no divergence. The per-tile part of a
//    window (its pair-bin row and `hi`) is taken up front with the other
//    blocks' bounds; the per-command part (the move, the clip, the
//    de-quantize: the arithmetic of frame.py's _shift_parts and
//    _dequant_parts, exact) runs in the staging thread, and the compositing
//    loop reads the staged values as before (decoding a command in every
//    compositing thread's registers spilled the compose kernel). On an H100
//    at the drag frames of the history view this costs K2 about 5 us a frame
//    (0.046 to 0.052 ms), where the torch launches it replaced took about
//    60 us; culling in the window's coordinates, the uniforms in shared
//    memory or the staged values moved in place did not take it lower;
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

// A block's kind: where its commands, bins and bounds come from.
constexpr int KIND_PLAIN = 0;    // f32 tables, i32 bins, per-tile bounds
constexpr int KIND_WINDOW = 1;   // a window's f32 tables and pair bins
constexpr int KIND_TAIL = 2;     // i16 tables and bins in the frame blob

// One block. Mirrored by _BLOCK_DESC in render/blocks_kernel.py.
struct BlockDesc {
  // shapes (N,16) | glyphs (N,8)       | images (N,8)
  // shape_clips   | glyph_colors (N,4) | image_clips
  // unused        | glyph_clips (N,4)  | unused
  // f32 (a window's in its own coordinates), or i16 in the blob (a tail)
  const void* t0;
  const void* t1;
  const void* t2;
  // plain: (T, k) i32, -1 = empty slot; window: pair bins (wr_cap,
  // tiles_x, k) i32; tail: (T, k) i16 in the blob
  const void* bins;
  // plain: (T,) i32 first slot, or null for 0; window: its uniform row in
  // the blob, 8 i16 (dx, dy at 1/8 px, clip x0, y0, x1, y1 at 1/4 px)
  const void* lo;
  // plain: (T,) i32 one past the last slot; window: pair counts (wr_cap,
  // tiles_x) i32; tail: unused (k, or 0 for a row that holds no entry)
  const int* hi;
  int cls;           // 0 shapes, 1 glyphs, 2 images
  int k;
  int kind;
  int aux;           // window: i16 from its uniform row to its (row0, WR)
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

// A pass of the staging: slots [s, s + STAGE_PASS) of row `row` of block
// b's bins, below hi. b == n_blocks: the walk is over.
struct Cursor {
  int b, s, hi, row;
};

// The slots of block `d` that tile (ty, tx), number t, composites, and the
// row of its bins they are in (`lo` and `row` of Cursor, `hi`). A window's
// row is its pair-bin row a = floor((ty * TILE_H - dy) / TILE_H) - row0, in
// f32 as frame.py::_pair_rows takes it, clamped into [0, WR); the tile
// composites none of it where a falls outside. A tail's row is drawn whole:
// its empty slots hold -1, which composites nothing.
__device__ __forceinline__ Cursor block_bounds(const BlockDesc& d, int b,
                                               int t, int ty, int tx,
                                               int tiles_x) {
  Cursor c;
  c.b = b;
  if (d.kind == KIND_WINDOW) {
    const short* uni = (const short*)d.lo;
    const float dy = (float)uni[1] * QUAD_XY_INV;
    const int row0 = uni[d.aux + 2 * d.cls];
    const int wr = uni[d.aux + 2 * d.cls + 1];
    const int a =
        (int)floorf(((float)(ty * TILE_H) - dy) / (float)TILE_H) - row0;
    c.row = min(max(a, 0), max(wr - 1, 0)) * tiles_x + tx;
    c.s = 0;
    c.hi = (a >= 0 && a < wr) ? min(d.hi[c.row], d.k) : 0;
  } else if (d.kind == KIND_TAIL) {
    // The host packs a row's entries first: a row that starts empty is.
    c.row = t;
    c.s = 0;
    c.hi = ((const short*)d.bins)[(size_t)t * d.k] >= 0 ? d.k : 0;
  } else {
    c.row = t;
    c.s = d.lo ? max(((const int*)d.lo)[t], 0) : 0;
    c.hi = min(d.hi[t], d.k);
  }
  return c;
}

// Column j of command idx's row of `tab` (`cols` wide): an f32, or for a
// tail an i16 of the blob times `inv`, the reciprocal of its column's scale.
__device__ __forceinline__ float table_value(bool tail, const void* tab,
                                             int cols, int idx, int j,
                                             float inv) {
  const size_t at = (size_t)idx * cols + j;
  return tail ? (float)((const short*)tab)[at] * inv
              : ((const float*)tab)[at];
}

// Command idx of a window or tail block as the kernel composites it: its
// first 8 columns (all a quad has, a shape's type, geometry, radius, border
// and first colour value) in `c`, its clip in `clip`. A window's values
// move by (dx, dy), a capsule's (type 1) both end points, a rect's, glyph's
// or image's origin, and its clip is the window's cut by the moved one:
// frame.py::_shift_parts, operation for operation.
__device__ __forceinline__ void resolved_command(const BlockDesc& d, int idx,
                                                 float c[8], float clip[4]) {
  const bool tail = d.kind == KIND_TAIL;
  const int cls = d.cls;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = cls == 0 ? table_value(tail, d.t0, 16, idx, j, SHAPE_INV[j])
                    : table_value(tail, d.t0, 8, idx, j,
                                  j < 4 ? QUAD_XY_INV : 1.0f);
  }
  const void* clips = cls == 1 ? d.t2 : d.t1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    clip[j] = table_value(tail, clips, 4, idx, j, CLIP_INV);
  }
  if (tail) return;
  const short* uni = (const short*)d.lo;
  const float dx = (float)uni[0] * QUAD_XY_INV;
  const float dy = (float)uni[1] * QUAD_XY_INV;
  if (cls == 0) {
    const float seg = c[0] == 1.0f ? 1.0f : 0.0f;
    c[1] = c[1] + dx;
    c[2] = c[2] + dy;
    c[3] = c[3] + seg * dx;
    c[4] = c[4] + seg * dy;
  } else {
    c[0] = c[0] + dx;
    c[1] = c[1] + dy;
  }
  clip[0] = fmaxf(clip[0] + dx, (float)uni[2] * CLIP_INV);
  clip[1] = fmaxf(clip[1] + dy, (float)uni[3] * CLIP_INV);
  clip[2] = fminf(clip[2] + dx, (float)uni[4] * CLIP_INV);
  clip[3] = fminf(clip[3] + dy, (float)uni[5] * CLIP_INV);
}

// `stage_pass` for a window or tail block: the command is resolved into
// registers for its extent, and once more, after the place is taken, to be
// written (the loads hit the cache), so that nothing of it is held across
// the CTA's barrier but its extent. → the new count.
__device__ __forceinline__ int stage_resolved(Staged* buf, int n,
                                              int* s_count, int idx,
                                              const BlockDesc& d,
                                              const UnitBox& u) {
  Extent e;
  bool keep = false;
  if (idx >= 0) {
    float c[8], clip[4];
    resolved_command(d, idx, c, clip);
    e = command_extent(d.cls, c, clip);
    keep = e.x1 >= u.x_lo && e.x0 <= u.x_hi && e.y1 >= u.y_lo
           && e.y0 <= u.y_hi;
  }
  int total;
  const int at = stage_place(n, s_count, keep, total);
  if (keep) {
    Staged& s = buf[at];
    float c[8], clip[4];
    resolved_command(d, idx, c, clip);
#pragma unroll
    for (int j = 0; j < 8; ++j) s.t[j] = c[j];
    const bool tail = d.kind == KIND_TAIL;
    if (d.cls == 0) {
      for (int j = 8; j < 16; ++j) {
        s.t[j] = table_value(tail, d.t0, 16, idx, j, SHAPE_INV[j]);
      }
    } else if (d.cls == 1) {
      for (int j = 0; j < 4; ++j) {
        s.t[8 + j] = table_value(tail, d.t1, 4, idx, j, COLOUR_INV);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s.clip[j] = clip[j];
    s.e = e;
    s.cls = d.cls;
  }
  return n + total;
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
  __shared__ int s_row[MAX_INLINE_BLOCKS];
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
  const UnitBox u = {((float)(strip * STRIP_W) + (float)ox) + 0.5f,
                     ((float)(strip * STRIP_W + STRIP_W - 1) + (float)ox)
                         + 0.5f,
                     (float)oy + 0.5f,
                     ((float)(UNIT_H - 1) + (float)oy) + 0.5f};

  const int n_blocks = p.n_blocks;
  const bool inl = n_blocks <= MAX_INLINE_BLOCKS;
  const BlockDesc* blocks = inl ? p.inline_blocks : p.blocks;
  if (inl && tid < n_blocks) {
    const Cursor c = block_bounds(blocks[tid], tid, t, ty, tx, p.tiles_x);
    s_lo[tid] = c.s;
    s_hi[tid] = c.hi;
    s_row[tid] = c.row;
  }
  __syncthreads();

  // Move `c` on to the first pass that holds a slot, at or after (b, s).
  auto seek = [&](Cursor& c) {
    while (c.b < n_blocks && c.s >= c.hi) {
      if (++c.b == n_blocks) break;
      if (inl) {
        c.s = s_lo[c.b];
        c.hi = s_hi[c.b];
        c.row = s_row[c.b];
      } else {
        c = block_bounds(blocks[c.b], c.b, t, ty, tx, p.tiles_x);
      }
    }
  };
  // This thread's slot of pass `c`: a command index, or -1.
  auto slot = [&](const Cursor& c) {
    const int k = c.s + tid;
    if (c.b >= n_blocks || tid >= STAGE_PASS || k >= c.hi) return -1;
    const BlockDesc& d = blocks[c.b];
    const size_t at = (size_t)c.row * d.k + k;
    return d.kind == KIND_TAIL ? (int)((const short*)d.bins)[at]
                               : ((const int*)d.bins)[at];
  };

  Cursor cur = {-1, 0, 0, 0};
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
      composite_staged(f, buf, n, p.font_tex, p.font_h, p.font_w,
                       p.image_atlas, p.atlas_h, p.atlas_w);
      if (!more) break;
      __syncthreads();
      n = 0;
    }

    // Stage pass `cur`: each thread's command, if it can ink this unit.
    const BlockDesc& d = blocks[cur.b];
    if (d.kind == KIND_PLAIN) {
      n = stage_pass(buf, n, s_count[parity], idx, d.cls,
                     (const float*)d.t0, (const float*)d.t1,
                     (const float*)d.t2, u);
    } else {
      n = stage_resolved(buf, n, s_count[parity], idx, d, u);
    }
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
        <<<n_tiles * (TILE_W / (W)) * (TILE_H / (ROW_STRIDE * (R))),       \
           (W) * ROW_STRIDE, 0, s>>>(*params);                             \
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
