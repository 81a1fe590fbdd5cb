// K2: the blocks rasterizer of the frame-cache path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_git_tpu/render/pallas_raster.py::render_tiles_blocks and its XLA
// epilogues `assemble_planar` (u8 frame) and `assemble_f32` (f32 layer).
//
// What it computes: per 64x128 tile, start from the background (alpha 1)
// or from a transparent canvas, then walk a z-ordered list of blocks. A
// block is one command class with its own tables, a bins table (T, k) and
// per-tile bounds: the tile composites slots [lo[t], hi[t]) of its bins
// row, skipping -1. Chrome z-segments share one bins table and differ only
// in their bounds; window blocks bring tables shifted for this frame and
// bins gathered from the scroll offset; the volatile tail comes last.
//
// What bounds it on this card: the same per-pixel ALU work as the packed
// tile kernel (raster_tiles.cu) over the same commands, plus conservative
// window slots that composite with coverage 0. Device-memory traffic is
// the command tables, the bins and bounds once, and the frame once. With
// one CTA a tile, a launch lasts as long as its busiest tile.
//
// What the design does about it:
//  * one CTA per tile, 512 threads x 16 pixels, RGBA in registers for the
//    whole walk, and the step functions of raster_steps.cuh, so a command
//    composites to the same bits here as in the packed kernel;
//  * a block is a loop range, not a launch: the CTA walks a flat array of
//    block descriptors in device memory (their number depends on the
//    scene, and would not fit the 4 KB parameter space), every thread
//    reading the same descriptor, so the loop stays uniform;
//  * two epilogues chosen by the caller: the interleaved (H, W, 4) u8
//    frame quantized in the kernel, or the (H, W, 4) f32 premultiplied
//    layer; neither writes past the frame's ragged edge.
#include <cuda_runtime.h>

#include "raster_steps.cuh"

namespace raster {

// One block. Mirrored by _BlockDesc in render/blocks_kernel.py.
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

// Mirrored by _BlocksParams in render/blocks_kernel.py.
struct BlocksParams {
  const BlockDesc* blocks;           // device memory, z order
  int n_blocks;
  int has_background;                // 0: transparent canvas, f32 output
  const unsigned char* font_tex;     // (font_h, font_w) SDF, 128 = edge
  int font_h, font_w;
  const unsigned char* image_atlas;  // (atlas_h, atlas_w, 4) rgba
  int atlas_h, atlas_w;
  float bg_r, bg_g, bg_b;
  int tiles_x, tiles_y, height, width;
  void* out;   // (height, width, 4): u8 with a background, else f32
};

__global__ void __launch_bounds__(THREADS, 1)
    raster_blocks_kernel(const __grid_constant__ BlocksParams p) {
  const int t = blockIdx.x;
  Pixels f;
  const int col = threadIdx.x % TILE_W;
  f.row0 = threadIdx.x / TILE_W;
  const int ox = (t % p.tiles_x) * TILE_W;
  const int oy = (t / p.tiles_x) * TILE_H;
  f.px = ((float)col + (float)ox) + 0.5f;
  f.oy = (float)oy;
  const float a0 = p.has_background ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    f.r[i] = p.has_background ? p.bg_r : 0.0f;
    f.g[i] = p.has_background ? p.bg_g : 0.0f;
    f.b[i] = p.has_background ? p.bg_b : 0.0f;
    f.a[i] = a0;
  }

#pragma unroll 1
  for (int b = 0; b < p.n_blocks; ++b) {
    const BlockDesc d = p.blocks[b];
    const int lo = d.lo ? max(d.lo[t], 0) : 0;
    const int hi = min(d.hi[t], d.k);
    const int* row = d.bins + (size_t)t * d.k;
    if (d.cls == 0) {
#pragma unroll 1
      for (int k = lo; k < hi; ++k) {
        const int idx = row[k];
        if (idx < 0) continue;
        shape_step(f, d.t0 + (size_t)idx * 16, d.t1 + (size_t)idx * 4);
      }
    } else if (d.cls == 1) {
#pragma unroll 1
      for (int k = lo; k < hi; ++k) {
        const int idx = row[k];
        if (idx < 0) continue;
        glyph_step(f, d.t0 + (size_t)idx * 8, d.t1 + (size_t)idx * 4,
                   d.t2 + (size_t)idx * 4, p.font_tex, p.font_h, p.font_w);
      }
    } else {
#pragma unroll 1
      for (int k = lo; k < hi; ++k) {
        const int idx = row[k];
        if (idx < 0) continue;
        image_step(f, d.t0 + (size_t)idx * 8, d.t1 + (size_t)idx * 4,
                   p.image_atlas, p.atlas_h, p.atlas_w);
      }
    }
  }

  if (p.has_background) {
    store_u8(f, ox + col, oy, (unsigned char*)p.out, p.height, p.width);
  } else {
    store_f32(f, ox + col, oy, (float*)p.out, p.height, p.width);
  }
}

}  // namespace raster

extern "C" {

// Launch one CTA per tile on `stream`, on the calling thread's current
// device. Returns cudaGetLastError(): a launch the runtime refused never
// runs, and a synchronize would not say.
int raster_blocks_launch(const raster::BlocksParams* params, int n_tiles,
                         void* stream) {
  raster::raster_blocks_kernel<<<n_tiles, raster::THREADS, 0,
                                 (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

const char* raster_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int raster_blocks_params_size() { return (int)sizeof(raster::BlocksParams); }

int raster_blocks_desc_size() { return (int)sizeof(raster::BlockDesc); }

}  // extern "C"
