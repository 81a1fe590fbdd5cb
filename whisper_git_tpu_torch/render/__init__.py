"""Frame renderer of the port: atlases, host binning, device unpack and
the tile rasterizer kernel."""
