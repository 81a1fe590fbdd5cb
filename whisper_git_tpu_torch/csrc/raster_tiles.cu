// K1: the packed-path tile rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_git_tpu/render/pallas_raster.py::render_tiles_pallas
// (`_kernel_body`) and its XLA epilogue `assemble_planar`.
//
// What bounds it on this card: per-pixel ALU work over the commands binned
// to each tile (an SDF, a clip test and a premultiplied blend per command
// per pixel; four atlas taps per glyph or image pixel). The command rows,
// bins and atlas cells are small and re-read by every pixel of a tile, so
// they are served by L1 and L2; device-memory traffic is the command
// tables once and the u8 frame once.
//
// What the design does about it:
//  * one CTA per 64x128 tile (130 tiles at 1280x800, about one wave on
//    132 SMs), 512 threads, 16 pixels a thread, the tile's RGBA in
//    registers for the whole command walk — no framebuffer round trips;
//  * each CTA reads its own bins row and walks it to the end, skipping -1
//    slots; the loop is uniform across the block, so there is no
//    divergence and no scalar prefetch;
//  * the x-dependent half of every command (clip column test, rect qx,
//    the glyph column taps) is computed once per thread, not per pixel;
//  * glyphs and images sample the u8 atlas with four bilinear taps instead
//    of the reference's two resampling matrix products (which exist
//    because TPU gathers are slow); the bf16 rounding of the tap weights
//    is reproduced so the result matches the reference;
//  * the kernel writes the interleaved (H, W, 4) u8 frame itself, with
//    clip(x * 255 + 0.5) and the ragged edge cropped, so the TPU path's
//    cell tables, bf16 atlas copies and planar transpose are gone.
#include <cuda_runtime.h>

#include "raster_steps.cuh"

namespace raster {

__global__ void __launch_bounds__(THREADS, 1)
    raster_tiles_kernel(const __grid_constant__ RasterParams p) {
  const int t = blockIdx.x;
  Pixels f;
  const int col = threadIdx.x % TILE_W;
  f.row0 = threadIdx.x / TILE_W;
  const int ox = (t % p.tiles_x) * TILE_W;
  const int oy = (t / p.tiles_x) * TILE_H;
  f.px = ((float)col + (float)ox) + 0.5f;
  f.oy = (float)oy;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    f.r[i] = p.bg_r;
    f.g[i] = p.bg_g;
    f.b[i] = p.bg_b;
    f.a[i] = 1.0f;
  }

#pragma unroll 1
  for (int l = 0; l < p.n_layers; ++l) {
    const LayerTables& L = p.layers[l];
    // Z order within a layer: shapes, then images, then glyphs.
    const int* sb = L.s_bins + (size_t)t * L.ks;
#pragma unroll 1
    for (int k = 0; k < L.ks; ++k) {
      const int idx = sb[k];
      if (idx < 0) continue;
      shape_step(f, L.shapes + (size_t)idx * 16, L.shape_clips + (size_t)idx * 4);
    }
    const int* ib = L.i_bins + (size_t)t * L.ki;
#pragma unroll 1
    for (int k = 0; k < L.ki; ++k) {
      const int idx = ib[k];
      if (idx < 0) continue;
      image_step(f, L.images + (size_t)idx * 8, L.image_clips + (size_t)idx * 4,
                 p.image_atlas, p.atlas_h, p.atlas_w);
    }
    const int* gb = L.g_bins + (size_t)t * L.kg;
#pragma unroll 1
    for (int k = 0; k < L.kg; ++k) {
      const int idx = gb[k];
      if (idx < 0) continue;
      glyph_step(f, L.glyphs + (size_t)idx * 8, L.glyph_colors + (size_t)idx * 4,
                 L.glyph_clips + (size_t)idx * 4, p.font_tex, p.font_h,
                 p.font_w);
    }
  }

  store_u8(f, ox + col, oy, p.out, p.height, p.width);
}

}  // namespace raster

extern "C" {

// Launch one CTA per tile on `stream`, on the calling thread's current
// device. Returns cudaGetLastError(): a launch the runtime refused never
// runs, and a synchronize would not say.
int raster_tiles_launch(const raster::RasterParams* params, int n_tiles,
                        void* stream) {
  raster::raster_tiles_kernel<<<n_tiles, raster::THREADS, 0,
                                (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

const char* raster_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int raster_params_size() { return (int)sizeof(raster::RasterParams); }

}  // extern "C"
