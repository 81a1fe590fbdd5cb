"""Numeric ops used by the views, on the host:

  bezier   — cubic-bezier eval/split/root-find, batched (numpy)
  lanes    — commit-graph lane assignment + row geometry (numpy)
  image    — Lanczos3 resize as separable matrix products (numpy)
  diffword — batched word-level diff highlight ranges (torch)
  sdf      — exact Euclidean distance transform for SDF glyph cells
             (torch, on the input's device)
"""
