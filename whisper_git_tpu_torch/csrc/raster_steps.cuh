// Per-command step functions of the tile rasterizer, shared by the kernels
// that composite commands onto a 64x128 tile held in registers.
//
// Counterparts of `_shape_step`, `_glyph_step` and `_image_step` in
// whisper_git_tpu/render/pallas_raster.py. The math follows the XLA scan
// the reference tests against (whisper_git_tpu/render/rasterizer.py
// `_shapes_pass`, `_glyphs_pass`, `_images_pass`) operation for operation;
// the library is built with --fmad=false so no multiply-add is contracted
// and every rounding matches the plain PyTorch version.
//
// Layout: a thread owns one column and N_ROWS rows of it, ROW_STRIDE apart
// (`PixelsT`), and the 32 threads of a warp own neighbouring columns of the
// same rows, so stores coalesce, the x-dependent half of every command is
// computed once per thread, and a test on a row or on the warp's columns is
// uniform across the warp. The tile kernel and the blocks kernel give a block
// a unit of a tile (a strip of its columns by a band of its rows), the
// compose kernel a strip of its rows, on the same struct.
//
// Work follows ink: `command_extent` gives the rectangle of pixel centres
// outside which a command's coverage is exactly 0, so that `over` is the
// identity there, and every step function skips the command for a warp whose
// columns or rows miss it, and the rows outside it. Skipping changes no bit.
// What bounds the step functions on this card is their scalar f32 arithmetic
// (a division, a `sqrtf`, no contracted multiply-add); the extent removes
// the part of it that multiplied by 0, and a shape without a border skips
// the ring's blend, which multiplied by 0 too.
//
// Staging (`stage_pass`, `composite_staged`): the tile and blocks kernels
// walk a tile's bins in passes of STAGE_PASS slots, a slot a thread; each
// thread drops its command if the extent misses the CTA's unit, and the
// survivors are written in z order (a ballot and a prefix) into a shared
// buffer that the compositing loop reads by broadcast.
#pragma once

#include <cuda_bf16.h>

namespace raster {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int CELL = 64;                           // atlas cell extent
constexpr int ROW_STRIDE = 4;                      // rows a thread skips
constexpr float SDF_SPREAD = 8.0f;                 // atlas px; 128 = edge

// This thread's pixels: one column, N_ROWS rows STRIDE apart, premultiplied
// RGBA. Row i lies at row0 + i * STRIDE below `oy`.
template <int N_ROWS, int STRIDE>
struct PixelsT {
  static constexpr int ROWS = N_ROWS;
  static constexpr int ROW_STRIDE = STRIDE;
  float px;   // column centre, screen px
  float oy;   // origin y of the rows (a tile's, or a row strip's)
  int row0;   // first row below the origin
  float r[N_ROWS], g[N_ROWS], b[N_ROWS], a[N_ROWS];

  __device__ __forceinline__ float py(int i) const {
    return ((float)(row0 + i * STRIDE) + oy) + 0.5f;
  }
};

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Premultiplied over: colour (cr, cg, cb) at coverage ca onto pixel i.
template <class PX>
__device__ __forceinline__ void over(PX& f, int i, float cr, float cg,
                                     float cb, float ca) {
  const float inv = 1.0f - ca;
  f.r[i] = cr * ca + f.r[i] * inv;
  f.g[i] = cg * ca + f.g[i] * inv;
  f.b[i] = cb * ca + f.b[i] * inv;
  f.a[i] = ca + f.a[i] * inv;
}

// Tent weight clip(1 - |s - j|, 0, 1) of texel j at sample coordinate s.
__device__ __forceinline__ float tent(float s, int j) {
  return clamp01(1.0f - fabsf(s - (float)j));
}

// The bilinear footprint of one sample coordinate on a CELL-texel axis:
// the two texels floor(s) and floor(s) + 1 (clamped to valid addresses)
// and their weights, zero for texels outside the cell and for samples
// outside (-1, extent) — exactly the non-zero entries of the reference's
// weight matrix row (`_sample_weights`).
struct Taps {
  int j0, j1;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float s, float extent) {
  Taps t;
  const bool inside = s > -1.0f && s < extent;
  const int j = (int)floorf(fminf(fmaxf(s, -2.0f), (float)CELL));
  t.w0 = (inside && j >= 0 && j < CELL) ? tent(s, j) : 0.0f;
  t.w1 = (inside && j + 1 >= 0 && j + 1 < CELL) ? tent(s, j + 1) : 0.0f;
  t.j0 = min(max(j, 0), CELL - 1);
  t.j1 = min(max(j + 1, 0), CELL - 1);
  return t;
}

// Sample coordinate of screen position p in a quad at origin/extent whose
// source region spans atlas_extent texels.
__device__ __forceinline__ float sample_coord(float p, float origin,
                                              float extent,
                                              float atlas_extent) {
  return (p - origin) / fmaxf(extent, 1e-6f) * atlas_extent - 0.5f;
}

// The rectangle of pixel centres, bounds inclusive, outside which a
// command's coverage is exactly 0. Mirrored by `command_extents` in
// render/raster_kernel.py: keep the two in step.
struct Extent {
  float x0, y0, x1, y1;
};

constexpr float EXTENT_PAD = 1.0f;   // one pixel more, against rounding

// cls 0: a shape (c: its 16 columns). Its box grown by 0.5 px, a capsule's
// segment box by half width + 0.5 px: beyond it d >= 0.5, so `inner` is 0
// and the border's coverage carries `inner` as a factor.
// cls 1, 2: a glyph or image quad (c: x, y, w, h, u, v, uw, uh) grown by one
// texel (w / uw px): outside it both taps of an axis weigh 0. An image's
// source is then 0. A glyph's `enc` is 0 and its distance 8 * screen_scale,
// which gives coverage 0 only when 8 * screen_scale / 0.7 >= 0.5; a glyph
// scaled below that is bounded by its clip alone.
// Every class: cut by the clip rect, whose mask multiplies the coverage.
__device__ __forceinline__ Extent command_extent(
    int cls, const float* __restrict__ c, const float* __restrict__ clip) {
  const float inf = __int_as_float(0x7f800000);
  float x0, y0, x1, y1;
  if (cls == 0) {
    if (c[0] == 1.0f) {
      const float g = fmaxf(c[5], 0.0f) + (0.5f + EXTENT_PAD);
      x0 = fminf(c[1], c[3]) - g;
      x1 = fmaxf(c[1], c[3]) + g;
      y0 = fminf(c[2], c[4]) - g;
      y1 = fmaxf(c[2], c[4]) + g;
    } else {
      const float g = 0.5f + EXTENT_PAD;
      x0 = fminf(c[1], c[1] + c[3]) - g;
      x1 = fmaxf(c[1], c[1] + c[3]) + g;
      y0 = fminf(c[2], c[2] + c[4]) - g;
      y1 = fmaxf(c[2], c[2] + c[4]) + g;
    }
  } else {
    const float w = fmaxf(c[2], 1e-6f), h = fmaxf(c[3], 1e-6f);
    float gx = c[6] > 0.0f ? w / c[6] + EXTENT_PAD : inf;
    float gy = c[7] > 0.0f ? h / c[7] + EXTENT_PAD : inf;
    if (cls == 1) {
      const float d = SDF_SPREAD * (c[2] / fmaxf(c[6], 1e-6f));
      if (!(d / 0.7f >= 0.5f)) gx = gy = inf;
    }
    x0 = c[0] - gx;
    x1 = (c[0] + w) + gx;
    y0 = c[1] - gy;
    y1 = (c[1] + h) + gy;
  }
  Extent e;
  e.x0 = fmaxf(x0, clip[0]);
  e.y0 = fmaxf(y0, clip[1]);
  e.x1 = fminf(x1, clip[2]);
  e.y1 = fminf(y1, clip[3]);
  return e;
}

// Whether any pixel of this warp can lie inside `e`: one of its 32 columns
// in the x range, and its first to last row overlapping the y range. Uniform
// across the warp; every thread of the warp must call it.
template <class PX>
__device__ __forceinline__ bool warp_hits(const PX& f, const Extent& e) {
  if (!__any_sync(0xffffffffu, f.px >= e.x0 && f.px <= e.x1)) return false;
  return f.py(PX::ROWS - 1) >= e.y0 && f.py(0) <= e.y1;
}

// Rounded rect (c[0] == 0) or capsule (c[0] == 1) with a border ring.
// c: 16 columns (type, x|x0, y|y0, w|x1, h|y1, radius|half width,
// border width, fill rgba, border rgba, pad). `e` is command_extent(0, c,
// clip), in the coordinates of f.px.
template <class PX>
__device__ __forceinline__ void shape_step(PX& f,
                                           const float* __restrict__ c,
                                           const float* __restrict__ clip,
                                           const Extent& e) {
  if (!warp_hits(f, e)) return;
  const float c0 = clip[0], c1 = clip[1], c2 = clip[2], c3 = clip[3];
  const bool is_seg = c[0] == 1.0f;
  const float hx = c[3] * 0.5f, hy = c[4] * 0.5f;
  const float cx = c[1] + hx, cy = c[2] + hy;
  const float rr = fminf(c[5], fminf(hx, hy));
  const float ax = c[1], ay = c[2], bx = c[3], by = c[4];
  const float abx = bx - ax, aby = by - ay;
  const float denom = fmaxf(abx * abx + aby * aby, 1e-6f);
  const float bw = c[6];
  const bool has_border = !is_seg && bw > 0.0f;
  const float fr = c[7], fg = c[8], fb = c[9], fa = c[10];
  const float br = c[11], bg = c[12], bb = c[13], ba = c[14];

  const float px = f.px;
  const bool in_x = px >= c0 && px <= c2;
  const float qx = fabsf(px - cx) - (hx - rr);
  const float mx = fmaxf(qx, 0.0f);
  const float sx = (px - ax) * abx;
#pragma unroll
  for (int i = 0; i < PX::ROWS; ++i) {
    const float py = f.py(i);
    if (py < e.y0 || py > e.y1) continue;   // uniform across the warp
    const float cm = (in_x && py >= c1 && py <= c3) ? 1.0f : 0.0f;
    float d;
    if (is_seg) {
      const float t = clamp01((sx + (py - ay) * aby) / denom);
      const float ex = px - (ax + t * abx), ey = py - (ay + t * aby);
      d = sqrtf(ex * ex + ey * ey) - c[5];
    } else {
      const float qy = fabsf(py - cy) - (hy - rr);
      const float my = fmaxf(qy, 0.0f);
      d = sqrtf(mx * mx + my * my) + fminf(fmaxf(qx, qy), 0.0f) - rr;
    }
    const float inner = clamp01(0.5f - d);
    over(f, i, fr, fg, fb, inner * cm * fa);
    // Without a border the ring's coverage is multiplied by 0 and its
    // `over` is the identity: skipped, for the whole command alike.
    if (has_border) {
      const float cov_b = inner * clamp01(d + bw + 0.5f) * cm;
      over(f, i, br, bg, bb, cov_b * ba);
    }
  }
}

// SDF glyph quad. Bilinear taps on the u8 atlas cell at (v, u), rounded
// like the reference's two bf16-operand products as XLA runs them: the
// tap weights rounded to bf16, the sums in f32 (the row-resampled texels
// stay f32 — XLA drops their bf16 round trip under jit). Each sum has the
// same two non-zero terms as the reference's 64-term matrix products.
template <class PX>
__device__ __forceinline__ void glyph_step(
    PX& f, const float* __restrict__ q, const float* __restrict__ col,
    const float* __restrict__ clip, const Extent& e,
    const unsigned char* __restrict__ tex, int tex_h, int tex_w) {
  if (!warp_hits(f, e)) return;
  const float x = q[0], y = q[1], w = q[2], h = q[3];
  const float u = q[4], v = q[5], uw = q[6], uh = q[7];
  const float c0 = clip[0], c1 = clip[1], c2 = clip[2], c3 = clip[3];
  const float cr = col[0], cg = col[1], cb = col[2], ca = col[3];
  const int v0 = min(max((int)v, 0), tex_h - CELL);
  const int u0 = min(max((int)u, 0), tex_w - CELL);
  const unsigned char* cell = tex + (size_t)v0 * tex_w + u0;
  const float screen_scale = w / fmaxf(uw, 1e-6f);

  const float px = f.px;
  const bool in_x = px >= c0 && px <= c2;
  const Taps tx = taps(sample_coord(px, x, w, uw), uw);
  const float wx0 = bf16_round(tx.w0), wx1 = bf16_round(tx.w1);
#pragma unroll
  for (int i = 0; i < PX::ROWS; ++i) {
    const float py = f.py(i);
    if (py < e.y0 || py > e.y1) continue;   // uniform across the warp
    const float cm = (in_x && py >= c1 && py <= c3) ? 1.0f : 0.0f;
    const Taps ty = taps(sample_coord(py, y, h, uh), uh);
    const float wy0 = bf16_round(ty.w0), wy1 = bf16_round(ty.w1);
    const unsigned char* r0 = cell + (size_t)ty.j0 * tex_w;
    const unsigned char* r1 = cell + (size_t)ty.j1 * tex_w;
    const float e0 = wy0 * (float)r0[tx.j0] + wy1 * (float)r1[tx.j0];
    const float e1 = wy0 * (float)r0[tx.j1] + wy1 * (float)r1[tx.j1];
    const float enc = wx0 * e0 + wx1 * e1;
    const float sdf_atlas = (128.0f - enc) * (SDF_SPREAD / 128.0f);
    const float d = sdf_atlas * screen_scale;
    const float cov = clamp01(0.5f - d / 0.7f) * cm;
    over(f, i, cr, cg, cb, cov * ca);
  }
}

// RGBA image quad: bilinear taps on the atlas cell at (v, u) in f32, as
// the reference's f32 einsum; alpha masked by the clip.
template <class PX>
__device__ __forceinline__ void image_step(
    PX& f, const float* __restrict__ q, const float* __restrict__ clip,
    const Extent& e, const unsigned char* __restrict__ atlas, int atlas_h,
    int atlas_w) {
  if (!warp_hits(f, e)) return;
  const float x = q[0], y = q[1], w = q[2], h = q[3];
  const float u = q[4], v = q[5], uw = q[6], uh = q[7];
  const float c0 = clip[0], c1 = clip[1], c2 = clip[2], c3 = clip[3];
  const int v0 = min(max((int)v, 0), atlas_h - CELL);
  const int u0 = min(max((int)u, 0), atlas_w - CELL);
  const uchar4* cell =
      reinterpret_cast<const uchar4*>(atlas) + (size_t)v0 * atlas_w + u0;

  const float px = f.px;
  const bool in_x = px >= c0 && px <= c2;
  const Taps tx = taps(sample_coord(px, x, w, uw), uw);
#pragma unroll
  for (int i = 0; i < PX::ROWS; ++i) {
    const float py = f.py(i);
    if (py < e.y0 || py > e.y1) continue;   // uniform across the warp
    const float cm = (in_x && py >= c1 && py <= c3) ? 1.0f : 0.0f;
    const Taps ty = taps(sample_coord(py, y, h, uh), uh);
    const uchar4 t00 = cell[(size_t)ty.j0 * atlas_w + tx.j0];
    const uchar4 t01 = cell[(size_t)ty.j0 * atlas_w + tx.j1];
    const uchar4 t10 = cell[(size_t)ty.j1 * atlas_w + tx.j0];
    const uchar4 t11 = cell[(size_t)ty.j1 * atlas_w + tx.j1];
#define RASTER_BILERP(ch)                                                 \
  ((tx.w0 * (ty.w0 * (float)t00.ch + ty.w1 * (float)t10.ch)             \
    + tx.w1 * (ty.w0 * (float)t01.ch + ty.w1 * (float)t11.ch)) / 255.0f)
    const float ir = RASTER_BILERP(x), ig = RASTER_BILERP(y);
    const float ib = RASTER_BILERP(z), ia = RASTER_BILERP(w);
#undef RASTER_BILERP
    over(f, i, ir, ig, ib, ia * cm);
  }
}

// Quantize this thread's pixels with clip(x * 255 + 0.5, 0, 255) and store
// them into the interleaved (height, width, 4) u8 frame; pixels past the
// frame's ragged edge are not written. `x` is the thread's column and `oy`
// the first row of its rows' origin, both in pixels of `out`.
__device__ __forceinline__ unsigned char quantize_u8(float v) {
  return (unsigned char)(fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f));
}

template <class PX>
__device__ __forceinline__ void store_u8(const PX& f, int x, int oy,
                                         unsigned char* out, int height,
                                         int width) {
  if (x >= width) return;
  uchar4* o4 = reinterpret_cast<uchar4*>(out);
#pragma unroll
  for (int i = 0; i < PX::ROWS; ++i) {
    const int y = oy + f.row0 + i * PX::ROW_STRIDE;
    if (y < height) {
      uchar4 o;
      o.x = quantize_u8(f.r[i]);
      o.y = quantize_u8(f.g[i]);
      o.z = quantize_u8(f.b[i]);
      o.w = quantize_u8(f.a[i]);
      o4[(size_t)y * width + x] = o;
    }
  }
}

// Store this thread's pixels unquantized into an interleaved (height,
// width, 4) f32 image (a premultiplied RGBA layer), cropped the same way.
template <class PX>
__device__ __forceinline__ void store_f32(const PX& f, int x, int oy,
                                          float* out, int height,
                                          int width) {
  if (x >= width) return;
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < PX::ROWS; ++i) {
    const int y = oy + f.row0 + i * PX::ROW_STRIDE;
    if (y < height) {
      o4[(size_t)y * width + x] = make_float4(f.r[i], f.g[i], f.b[i], f.a[i]);
    }
  }
}

// Store this thread's pixels as an interleaved (height, width, 4) i16 layer,
// fixed point at 1/32767: clamp(round_half_even(v * 32767), +-32767), the
// values the compose kernel reads. Cropped the same way.
__device__ __forceinline__ short quantize_i16(float v) {
  return (short)min(max(__float2int_rn(v * 32767.0f), -32767), 32767);
}

template <class PX>
__device__ __forceinline__ void store_i16(const PX& f, int x, int oy,
                                          short* out, int height, int width) {
  if (x >= width) return;
  short4* o4 = reinterpret_cast<short4*>(out);
#pragma unroll
  for (int i = 0; i < PX::ROWS; ++i) {
    const int y = oy + f.row0 + i * PX::ROW_STRIDE;
    if (y < height) {
      o4[(size_t)y * width + x] =
          make_short4(quantize_i16(f.r[i]), quantize_i16(f.g[i]),
                      quantize_i16(f.b[i]), quantize_i16(f.a[i]));
    }
  }
}

// ---- The frame blob's fixed point -----------------------------------------

// The reciprocals of the fixed-point scales of a shape command's 16 columns
// (geometry at 1/8 px, colours at 1/8192: wire.SHAPE_COL_SCALE), of a
// glyph or image quad's 8 (x, y, w, h at 1/8 px, the atlas cell's u, v, uw,
// uh whole), of a glyph's colour (1/8192) and of a clip rect (1/4 px), as
// np.float32(1 / scale) gives them. Every scale is a power of two, so a
// value times its reciprocal is exact.
__constant__ float SHAPE_INV[16] = {
    1.0f / 8.0f,    1.0f / 8.0f,    1.0f / 8.0f,    1.0f / 8.0f,
    1.0f / 8.0f,    1.0f / 8.0f,    1.0f / 8.0f,    1.0f / 8192.0f,
    1.0f / 8192.0f, 1.0f / 8192.0f, 1.0f / 8192.0f, 1.0f / 8192.0f,
    1.0f / 8192.0f, 1.0f / 8192.0f, 1.0f / 8192.0f, 1.0f / 8.0f};
constexpr float QUAD_XY_INV = 1.0f / 8.0f;   // columns 0-3; 4-7 are whole
constexpr float COLOUR_INV = 1.0f / 8192.0f;
constexpr float CLIP_INV = 1.0f / 4.0f;

// ---- Staging: a tile's commands in shared memory, culled to a unit --------

constexpr int STAGE_PASS = 128;   // bins slots examined at a time
constexpr int STAGE_CAP = 192;    // commands the shared buffer holds

// CTAs an SM should hold: as many as its 65536 registers allow at 128, 96
// or 64 registers a thread for 16, 8 or 4 rows a thread.
constexpr int min_ctas(int threads, int n_rows) {
  return 65536 / (threads * (n_rows >= 16 ? 128 : n_rows >= 8 ? 96 : 64));
}

// One command in shared memory.
struct __align__(16) Staged {
  float t[16];     // shape: 16 columns | glyph: quad 8, colour 4 | image: 8
  float clip[4];
  Extent e;
  int cls;
  int pad[3];
};

// The pixel centres a CTA owns, bounds inclusive.
struct UnitBox {
  float x_lo, x_hi, y_lo, y_hi;
};

// The place in the shared buffer of this thread's command where it is kept,
// after the `n` commands staged before, in slot order: a ballot a warp, a
// prefix over the counts of the first STAGE_PASS / 32 warps (`s_count`, one
// of two arrays taken in turns, so that no pass overwrites what the last
// one's prefix still reads). Every thread of the CTA calls it; `total` is
// the pass's count of kept commands.
__device__ __forceinline__ int stage_place(int n, int* s_count, bool keep,
                                           int& total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid < STAGE_PASS && lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int base = n;
  total = 0;
#pragma unroll
  for (int w = 0; w < STAGE_PASS / 32; ++w) {
    const int cw = s_count[w];
    if (w < warp) base += cw;
    total += cw;
  }
  return base + __popc(ballot & ((1u << lane) - 1u));
}

// Stage one pass. This thread's slot holds command `idx` (-1: none) of
// class `cls` (0 shapes, 1 glyphs, 2 images), whose tables are
// t0: shapes (N,16) | glyphs (N,8)       | images (N,8)
// t1: shape_clips   | glyph_colors (N,4) | image_clips
// t2: unused        | glyph_clips (N,4)  | unused;
// it is kept if its extent meets the unit, and written where `stage_place`
// puts it. Every thread of the CTA calls it. → the new count.
__device__ __forceinline__ int stage_pass(Staged* buf, int n, int* s_count,
                                          int idx, int cls,
                                          const float* t0, const float* t1,
                                          const float* t2, const UnitBox& u) {
  const float* c = nullptr;
  const float* colour = nullptr;
  const float* clip = nullptr;
  Extent e;
  bool keep = false;
  if (idx >= 0) {
    if (cls == 0) {
      c = t0 + (size_t)idx * 16;
      clip = t1 + (size_t)idx * 4;
    } else if (cls == 1) {
      c = t0 + (size_t)idx * 8;
      colour = t1 + (size_t)idx * 4;
      clip = t2 + (size_t)idx * 4;
    } else {
      c = t0 + (size_t)idx * 8;
      clip = t1 + (size_t)idx * 4;
    }
    e = command_extent(cls, c, clip);
    keep = e.x1 >= u.x_lo && e.x0 <= u.x_hi && e.y1 >= u.y_lo
           && e.y0 <= u.y_hi;
  }
  int total;
  const int at = stage_place(n, s_count, keep, total);
  if (keep) {
    Staged& s = buf[at];
    const int nc = cls == 0 ? 16 : 8;
    for (int j = 0; j < nc; ++j) s.t[j] = c[j];
    if (cls == 1) {
      for (int j = 0; j < 4; ++j) s.t[8 + j] = colour[j];
    }
    for (int j = 0; j < 4; ++j) s.clip[j] = clip[j];
    s.e = e;
    s.cls = cls;
  }
  return n + total;
}

// Composite the `n` staged commands onto this thread's pixels, in order.
// The caller synchronizes the CTA before (the buffer is written) and after
// (it is written again).
template <class PX>
__device__ __forceinline__ void composite_staged(
    PX& f, const Staged* buf, int n, const unsigned char* __restrict__ font,
    int font_h, int font_w, const unsigned char* __restrict__ atlas,
    int atlas_h, int atlas_w) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const Staged& s = buf[j];
    if (s.cls == 0) {
      shape_step(f, s.t, s.clip, s.e);
    } else if (s.cls == 1) {
      glyph_step(f, s.t, s.t + 8, s.clip, s.e, font, font_h, font_w);
    } else {
      image_step(f, s.t, s.clip, s.e, atlas, atlas_h, atlas_w);
    }
  }
}

}  // namespace raster
