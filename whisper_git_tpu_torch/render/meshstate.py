"""Render-mesh state: which device mesh (if any) the frame pipeline shards
over.

Counterpart of `whisper_git_tpu/render/meshstate.py`. The frame paths
(render/frame.py's frame cache, render/compose.py's layer builds and blend)
consult this holder every frame; when a mesh is set, each of its shards
renders a slice of whole tile rows through the same kernels, on its own
device, and the slices are gathered into the frame (parallel/mesh.py says
how). `parallel.mesh` re-exports the setters as the public API;
`Renderer.__init__` installs a mesh when the process sees more than one
card.

`CPU_DEVICES` is the port's counterpart of XLA's virtual host device
count: how many entries a mesh over the CPU may have (each the CPU). It is
1, so the CPU offers no mesh unless a caller (the tests) raises it.
"""

from __future__ import annotations

import os

import torch

_RENDER_MESH = [None]

# Mesh entries the CPU offers (XLA's --xla_force_host_platform_device_count
# in the reference); the tests set it.
CPU_DEVICES = 1


def set_render_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh the frame pipeline shards
    over. Takes effect on the next rendered frame: the compose plans and
    stacks key on the mesh."""
    _RENDER_MESH[0] = mesh


def get_render_mesh():
    return _RENDER_MESH[0]


def available_devices(device=None) -> list:
    """The devices a mesh on `device`'s platform may use: every card for a
    CUDA device (the default where there is a card), `CPU_DEVICES` times
    the CPU for the CPU. The cards start at `device`'s own (the current
    card where it names none) and wrap around, so a mesh over them gathers
    its frames onto the card its renderer draws on: `cuda:1` of four gives
    cuda:1, cuda:2, cuda:3, cuda:0."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        first = torch.cuda.current_device() if dev.index is None \
            else dev.index
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    return [torch.device("cpu")] * CPU_DEVICES


def maybe_auto_mesh(device=None):
    """Install a (1, n) render mesh over the cards of `device`'s platform
    when more than one is visible (`available_devices`: `device`'s card
    first). WGIT_MESH=0 disables; WGIT_MESH=<int> forces a device count,
    n = min(int, available) (the tests' way in on the CPU, where auto mode
    stays off). → the mesh, or None."""
    want = os.environ.get("WGIT_MESH", "auto")
    if want in ("0", "off", "none", ""):
        return None
    devices = available_devices(device)
    if want == "auto":
        if devices[0].type == "cpu" or len(devices) < 2:
            return None
        n = len(devices)
    else:
        try:
            n = min(int(want), len(devices))
        except ValueError:
            return None
    if n < 2:
        return None
    from ..parallel.mesh import Mesh

    mesh = Mesh([devices[:n]])
    set_render_mesh(mesh)
    return mesh
