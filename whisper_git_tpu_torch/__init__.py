"""whisper_git_tpu_torch — the PyTorch / CUDA port of the frame renderer.

The JAX package (`whisper_git_tpu`) stays the reference, and this package
imports nothing of it: `app/`, `ui/`, `engine/`, `gitcore/`, `services/`,
`ops/lanes.py`, `ops/bezier.py` (its numpy half), `render/scene.py`,
`render/shaping.py` and the atlas types in `render/atlas.py` are its own
copies of the reference's device-free modules. What touches the device is
written for PyTorch and CUDA:

  render/atlas.py          font atlases loaded from data/atlas.npz
  render/rasterizer.py     frame entry points; the packed path: host
                           binning (numpy) + device unpack (torch)
  render/frame.py          the frame cache: chrome and windows resident on
                           the device, block lists built per frame
  render/raster_kernel.py  K1, the tile rasterizer: CUDA kernel + plain
                           version (packed path)
  render/blocks_kernel.py  K2, the blocks rasterizer: CUDA kernel + plain
                           version (frame cache)
  render/renderer.py       Renderer facade, PNG writer, kernel builds
  ops/image.py             Lanczos resize of image tiles (numpy)
  ops/diffword.py          batched word-diff ranges (torch)
  host/                    the interactive terminal loop and its
                           presenter, the headless screenshot CLI
  ledger.py                the cache ledger the loop dumps
  bench.py                 the history-view frame bench
  csrc/                    CUDA C++ sources, built at first CUDA launch

It imports torch and numpy, and never jax, PIL, matplotlib or
whisper_git_tpu.
"""

__version__ = "0.2.0"
