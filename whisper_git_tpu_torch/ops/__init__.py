"""Numeric ops used by the views, on the host:

  bezier   — cubic-bezier eval/split/root-find, batched (numpy)
  lanes    — commit-graph lane assignment + row geometry (numpy)
  image    — Lanczos3 resize as separable matrix products (numpy)

The reference's other ops (`sdf`, `diffword`) run on JAX and are not
ported yet; a view that reaches one fails with an
ImportError of this package.
"""
