"""whisper_git_tpu_torch — the PyTorch / CUDA port of the frame renderer.

The JAX package (`whisper_git_tpu`) stays the reference. This package
reuses its device-free modules read-only (`ui/`, `app/`, `gitcore/`,
`engine/`, `services/`, the scene compiler in `render/scene.py`, the atlas
types, text shaping, and the CLI's option parser) and owns everything that
touches the device:

  render/scene.py          jax-free `_bucket` (installed over the reference's)
  render/atlas.py          font atlases loaded from data/atlas.npz
  render/rasterizer.py     host binning (numpy) + device unpack (torch)
  render/raster_kernel.py  the tile rasterizer: CUDA kernel + plain version
  render/renderer.py       Renderer facade, PNG writer
  host/                    headless screenshot CLI
  csrc/                    CUDA C++ sources, built at first CUDA launch

It imports torch and numpy, and never jax, PIL or matplotlib.
"""

__version__ = "0.1.0"
