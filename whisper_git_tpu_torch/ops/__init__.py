"""Numeric ops used by the views, on the host:

  bezier   — cubic-bezier eval/split/root-find, batched (numpy)
  lanes    — commit-graph lane assignment + row geometry (numpy)
  image    — Lanczos3 resize as separable matrix products (numpy)
  diffword — batched word-level diff highlight ranges (torch)

The reference's `sdf` (the EDT) runs on JAX and is not ported yet; a view
that reaches it fails with an ImportError of this package.
"""
