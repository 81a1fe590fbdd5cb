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
// Layout: a block of THREADS threads owns one tile. Thread i owns column
// i % TILE_W and rows i / TILE_W + ROW_STRIDE * r for r < ROWS, so a warp
// covers 32 neighbouring columns of one row (coalesced stores) and the
// x-dependent half of every command is computed once per thread.
#pragma once

#include <cuda_bf16.h>

namespace raster {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int CELL = 64;                           // atlas cell extent
constexpr int THREADS = 512;
constexpr int ROWS = TILE_H * TILE_W / THREADS;    // 16 pixels a thread
constexpr int ROW_STRIDE = THREADS / TILE_W;       // 4
constexpr int MAX_LAYERS = 4;
constexpr float SDF_SPREAD = 8.0f;                 // atlas px; 128 = edge

// One layer's command tables (row-major f32) and bins ((T, k) i32, -1 =
// empty slot). A width of 0 skips the class. Mirrored by _LayerTables in
// render/raster_kernel.py: keep the two in step.
struct LayerTables {
  const float* shapes;        // (NS, 16)
  const float* shape_clips;   // (NS, 4) x0, y0, x1, y1
  const float* glyphs;        // (NG, 8) x, y, w, h, u, v, uw, uh
  const float* glyph_colors;  // (NG, 4) premultiplied rgba
  const float* glyph_clips;   // (NG, 4)
  const float* images;        // (NI, 8) x, y, w, h, u, v, uw, uh
  const float* image_clips;   // (NI, 4)
  const int* s_bins;
  const int* g_bins;
  const int* i_bins;
  int ks, kg, ki;
  int pad;
};

// Mirrored by _RasterParams in render/raster_kernel.py.
struct RasterParams {
  LayerTables layers[MAX_LAYERS];
  const unsigned char* font_tex;     // (font_h, font_w) SDF, 128 = edge
  int font_h, font_w;
  const unsigned char* image_atlas;  // (atlas_h, atlas_w, 4) rgba
  int atlas_h, atlas_w;
  float bg_r, bg_g, bg_b;
  int n_layers, tiles_x, tiles_y, height, width;
  unsigned char* out;                // (height, width, 4)
};

// This thread's pixels: one column, ROWS rows, premultiplied RGBA.
struct Pixels {
  float px;   // column centre, screen px
  float oy;   // tile origin y
  int row0;   // first row inside the tile
  float r[ROWS], g[ROWS], b[ROWS], a[ROWS];

  __device__ __forceinline__ float py(int i) const {
    return ((float)(row0 + i * ROW_STRIDE) + oy) + 0.5f;
  }
};

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Premultiplied over: colour (cr, cg, cb) at coverage ca onto pixel i.
__device__ __forceinline__ void over(Pixels& f, int i, float cr, float cg,
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

// Rounded rect (c[0] == 0) or capsule (c[0] == 1) with a border ring.
// c: 16 columns (type, x|x0, y|y0, w|x1, h|y1, radius|half width,
// border width, fill rgba, border rgba, pad).
__device__ __forceinline__ void shape_step(Pixels& f,
                                           const float* __restrict__ c,
                                           const float* __restrict__ clip) {
  const float c0 = clip[0], c1 = clip[1], c2 = clip[2], c3 = clip[3];
  const bool is_seg = c[0] == 1.0f;
  const float hx = c[3] * 0.5f, hy = c[4] * 0.5f;
  const float cx = c[1] + hx, cy = c[2] + hy;
  const float rr = fminf(c[5], fminf(hx, hy));
  const float ax = c[1], ay = c[2], bx = c[3], by = c[4];
  const float abx = bx - ax, aby = by - ay;
  const float denom = fmaxf(abx * abx + aby * aby, 1e-6f);
  const float bw = c[6];
  const float border_on = (!is_seg && bw > 0.0f) ? 1.0f : 0.0f;
  const float fr = c[7], fg = c[8], fb = c[9], fa = c[10];
  const float br = c[11], bg = c[12], bb = c[13], ba = c[14];

  const float px = f.px;
  const bool in_x = px >= c0 && px <= c2;
  const float qx = fabsf(px - cx) - (hx - rr);
  const float mx = fmaxf(qx, 0.0f);
  const float sx = (px - ax) * abx;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float py = f.py(i);
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
    const float cov_b = inner * clamp01(d + bw + 0.5f) * cm * border_on;
    over(f, i, br, bg, bb, cov_b * ba);
  }
}

// SDF glyph quad. Bilinear taps on the u8 atlas cell at (v, u), rounded
// like the reference's two bf16-operand products as XLA runs them: the
// tap weights rounded to bf16, the sums in f32 (the row-resampled texels
// stay f32 — XLA drops their bf16 round trip under jit). Each sum has the
// same two non-zero terms as the reference's 64-term matrix products.
__device__ __forceinline__ void glyph_step(
    Pixels& f, const float* __restrict__ q, const float* __restrict__ col,
    const float* __restrict__ clip, const unsigned char* __restrict__ tex,
    int tex_h, int tex_w) {
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
  for (int i = 0; i < ROWS; ++i) {
    const float py = f.py(i);
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
__device__ __forceinline__ void image_step(
    Pixels& f, const float* __restrict__ q, const float* __restrict__ clip,
    const unsigned char* __restrict__ atlas, int atlas_h, int atlas_w) {
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
  for (int i = 0; i < ROWS; ++i) {
    const float py = f.py(i);
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
// its tile's first row, both in frame pixels.
__device__ __forceinline__ unsigned char quantize_u8(float v) {
  return (unsigned char)(fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f));
}

__device__ __forceinline__ void store_u8(const Pixels& f, int x, int oy,
                                         unsigned char* out, int height,
                                         int width) {
  if (x >= width) return;
  uchar4* o4 = reinterpret_cast<uchar4*>(out);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = oy + f.row0 + i * ROW_STRIDE;
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
__device__ __forceinline__ void store_f32(const Pixels& f, int x, int oy,
                                          float* out, int height,
                                          int width) {
  if (x >= width) return;
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = oy + f.row0 + i * ROW_STRIDE;
    if (y < height) {
      o4[(size_t)y * width + x] = make_float4(f.r[i], f.g[i], f.b[i], f.a[i]);
    }
  }
}

}  // namespace raster
