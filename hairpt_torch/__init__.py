"""hairpt_torch — the PyTorch/CUDA port of hairpt for one NVIDIA H100.

The package mirrors `hairpt/`'s layout module for module. It imports
torch and numpy only: the JAX package is the reference the tests compare
against, never a dependency. Entry points run on the card ("cuda") unless
the caller passes `device="cpu"`; asking for CUDA on a machine without it
raises instead of silently falling back. The command line,
`python -m hairpt_torch.cli render scene.xml`, renders a scene XML
(`scene/xml_loader.py`: hair and triangle-mesh scenes) on the card, or
on the CPU with `--cpu`; its `util` command resamples, tonemaps and
combines images and its `import` command converts COLLADA documents.

The hand-written CUDA kernels live in `csrc/`: the tiled intersector's
phase-A tile cull and phase-B miter-cylinder test (`tiled.cu`, kernels A
and B) and its octet and stream modes (`octets.cu`, C and D), bound
through `ops/tiled_kernels.py`; the swept traversal's phase A
(`swept_cull.cu`) and chunk test (`phaseb.cu`, kernel E), bound through
`ops/phaseb_kernels.py`; the packed BVH walk over triangles (and hair
under traversal='packed'), `packed.cu` (kernel F), bound through
`ops/intersect_packed.py`; the two-level walk of instanced meshes,
`instanced.cu` (kernel G), bound through `ops/instancing.py`; and the
per-ray and the blocked walks over the SoA trees (traversal 'perray'
and 'blocked'), `perray.cu` (kernel H) and `blocked.cu` (kernel I),
bound through `ops/intersect.py` and `ops/intersect_blocked.py`; and
Woodcock tracking through a grid volume (delta and ratio tracking of a
heterogeneous medium), `woodcock.cu` (kernel J), bound through
`models/media.py`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. CPU only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hairpt_torch: CUDA was requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    return dev
