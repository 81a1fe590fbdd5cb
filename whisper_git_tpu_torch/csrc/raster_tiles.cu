// K1: the tile rasterizer of the packed path and of oversized scenes, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_git_tpu/render/pallas_raster.py::render_tiles_pallas
// (`_kernel_body`) and its XLA epilogue `assemble_planar`.
//
// What it computes: per 64x128 tile, start from the background, then for
// each of up to four layers composite the commands binned to the tile, in
// the layer's z order: shapes, then images, then glyphs. A layer brings its
// f32 command tables and a (T, k) i32 bins table a class, padded with -1 to
// the busiest tile's count; the output is the (H, W, 4) u8 frame.
//
// What bounds it on this card: operations, the step functions' scalar f32
// arithmetic on the pixels a command inks (raster_steps.cuh), run by warps
// that a narrow glyph fills to a third. Device-memory traffic is the
// command tables and bins once and the frame once. Before this design a CTA
// of 512 threads owned a whole tile (130 CTAs at 1280x800, one an SM, a
// launch as long as its busiest tile), and every thread fetched each command
// of its tile through two dependent loads, recomputed its extent and walked
// the rows' -1 padding.
//
// What the design does about it:
//  * a CTA owns a unit of a tile, STRIP_W columns by 4 x N_ROWS rows (32 x
//    16 by default: 128 threads x 4 pixels, 16 CTAs a tile, 2080 a
//    1280x800 frame, eight resident on an SM at 64 registers), so a busy
//    tile spreads over many SMs; the unit is a template parameter, and the
//    one instantiated (UNIT_W, UNIT_ROWS) was the fastest of five measured;
//  * the tile's bins are walked layer by layer and class by class in z
//    order, in passes of STAGE_PASS slots, a slot a thread: the thread
//    computes its command's extent once and drops the command if it misses
//    the unit, and the survivors are staged in z order in shared memory
//    (`stage_pass`), so -1 slots and commands of other units cost one load
//    and no compositing. The compositing loop reads the buffer by broadcast,
//    with no global load in its chain; the next pass's slot is loaded
//    before this pass is staged;
//  * the launch is one a frame, and the per-layer tables ride in its
//    parameter block (`RasterParams`);
//  * work follows ink inside the step functions too: a warp skips the
//    commands and rows its pixels miss (`command_extent`), bit for bit;
//  * glyphs and images sample the u8 atlas with four bilinear taps instead
//    of the reference's two resampling matrix products (which exist
//    because TPU gathers are slow); the bf16 rounding of the tap weights
//    is reproduced so the result matches the reference;
//  * the kernel writes the interleaved (H, W, 4) u8 frame itself, with
//    clip(x * 255 + 0.5) and the ragged edge cropped;
//  * a slice of a device mesh (`render_batch_sharded`) launches tiles
//    [tile0, tile0 + n) only, with pixel origins and bins rows from the
//    global tile id, and writes their f32 canvas before the quantize as
//    whole (64, 128, 4) tiles, as the reference's `_render_tile_slice`
//    returns it.
#include <cuda_runtime.h>

#include "raster_steps.cuh"

namespace raster {

constexpr int MAX_LAYERS = 4;

// One layer's command tables (row-major f32) and bins ((T, k) i32, -1 =
// empty slot). A width of 0 skips the class. Packed by _LAYER_PACK in
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

// Packed by _pack_params in render/raster_kernel.py.
struct RasterParams {
  LayerTables layers[MAX_LAYERS];
  const unsigned char* font_tex;     // (font_h, font_w) SDF, 128 = edge
  int font_h, font_w;
  const unsigned char* image_atlas;  // (atlas_h, atlas_w, 4) rgba
  int atlas_h, atlas_w;
  float bg_r, bg_g, bg_b;
  int n_layers, tiles_x, tiles_y, height, width;
  void* out;                         // (height, width, 4) u8, or with
                                     // out_f32 (n, TILE_H, TILE_W, 4) f32
  int tile0;                         // global id of the first tile launched
  int out_f32;
};

// A pass of the walk: slots [s, s + STAGE_PASS) of the bins row of class
// slot z (0 shapes, 1 images, 2 glyphs: the z order) of layer l, below the
// row's width k. l == n_layers: the walk is over.
struct TileCursor {
  int l, z, s, k;
};

__device__ __forceinline__ int z_width(const LayerTables& L, int z) {
  return z == 0 ? L.ks : z == 1 ? L.ki : L.kg;
}

// The unit the launch takes: UNIT_W columns by ROW_STRIDE * UNIT_ROWS rows
// (32 x 16, 16 CTAs a tile), the fastest of five units measured on an H100.
constexpr int UNIT_W = 32;
constexpr int UNIT_ROWS = 4;

template <int STRIP_W, int N_ROWS>
__global__ void __launch_bounds__(STRIP_W * ROW_STRIDE,
                                  min_ctas(STRIP_W * ROW_STRIDE, N_ROWS))
    raster_tiles_kernel(const __grid_constant__ RasterParams p) {
  using PX = PixelsT<N_ROWS, ROW_STRIDE>;
  constexpr int UNIT_H = ROW_STRIDE * N_ROWS;
  constexpr int SPLIT_X = TILE_W / STRIP_W, SPLIT_Y = TILE_H / UNIT_H;
  __shared__ Staged buf[STAGE_CAP];
  __shared__ int s_count[2][STAGE_PASS / 32];

  const int tid = threadIdx.x;
  const int lt = blockIdx.x / (SPLIT_X * SPLIT_Y);   // tile of the launch
  const int t = p.tile0 + lt;                        // tile of the grid
  const int unit = blockIdx.x % (SPLIT_X * SPLIT_Y);
  const int strip = unit % SPLIT_X, band = unit / SPLIT_X;
  const int col = strip * STRIP_W + tid % STRIP_W;
  const int ox = (t % p.tiles_x) * TILE_W;
  const int oy = (t / p.tiles_x) * TILE_H + band * UNIT_H;
  PX f;
  f.row0 = tid / STRIP_W;
  f.px = ((float)col + (float)ox) + 0.5f;
  f.oy = (float)oy;
#pragma unroll
  for (int i = 0; i < N_ROWS; ++i) {
    f.r[i] = p.bg_r;
    f.g[i] = p.bg_g;
    f.b[i] = p.bg_b;
    f.a[i] = 1.0f;
  }
  const UnitBox u = {((float)(strip * STRIP_W) + (float)ox) + 0.5f,
                     ((float)(strip * STRIP_W + STRIP_W - 1) + (float)ox)
                         + 0.5f,
                     (float)oy + 0.5f,
                     ((float)(UNIT_H - 1) + (float)oy) + 0.5f};
  const int n_layers = p.n_layers;

  // Move `c` on to the first pass that holds a slot, at or after (l, z, s).
  auto seek = [&](TileCursor& c) {
    while (c.l < n_layers && c.s >= c.k) {
      c.s = 0;
      if (++c.z == 3) {
        c.z = 0;
        if (++c.l == n_layers) break;
      }
      c.k = z_width(p.layers[c.l], c.z);
    }
  };
  // This thread's slot of pass `c`: a command index, or -1.
  auto slot = [&](const TileCursor& c) {
    const int k = c.s + tid;
    if (c.l >= n_layers || tid >= STAGE_PASS || k >= c.k) return -1;
    const LayerTables& L = p.layers[c.l];
    const int* bins = c.z == 0 ? L.s_bins : c.z == 1 ? L.i_bins : L.g_bins;
    return bins[(size_t)t * c.k + k];
  };

  TileCursor cur = {0, 0, 0, z_width(p.layers[0], 0)};
  seek(cur);
  int idx = slot(cur);
  int n = 0, parity = 0;
#pragma unroll 1
  while (true) {
    const bool more = cur.l < n_layers;
    TileCursor nxt = cur;
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
    const LayerTables& L = p.layers[cur.l];
    const int z = cur.z;
    n = stage_pass(buf, n, s_count[parity], idx, z == 0 ? 0 : z == 1 ? 2 : 1,
                   z == 0 ? L.shapes : z == 1 ? L.images : L.glyphs,
                   z == 0 ? L.shape_clips
                          : z == 1 ? L.image_clips : L.glyph_colors,
                   L.glyph_clips, u);
    parity ^= 1;
    cur = nxt;
    idx = idx_nxt;
  }

  if (p.out_f32) {
    store_f32(f, col, band * UNIT_H,
              (float*)p.out + (size_t)lt * (TILE_H * TILE_W * 4), TILE_H,
              TILE_W);
  } else {
    store_u8(f, ox + col, oy, (unsigned char*)p.out, p.height, p.width);
  }
}

}  // namespace raster

extern "C" {

// Launch `n_tiles` tiles of `params` from its `tile0` on `stream`, on the
// calling thread's current device: a CTA a unit of UNIT_W x (ROW_STRIDE *
// UNIT_ROWS) pixels of a tile. Returns cudaGetLastError(): a launch the
// runtime refused never runs, and a synchronize would not say.
int raster_tiles_launch(const raster::RasterParams* params, int n_tiles,
                        void* stream) {
  using namespace raster;
  raster_tiles_kernel<UNIT_W, UNIT_ROWS>
      <<<n_tiles * (TILE_W / UNIT_W) * (TILE_H / (ROW_STRIDE * UNIT_ROWS)),
         UNIT_W * ROW_STRIDE, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

const char* raster_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int raster_params_size() { return (int)sizeof(raster::RasterParams); }

}  // extern "C"
