"""The repository's example programs on the port (the counterparts of
``examples/*.py``, which run on the JAX package).

    python -m nanort_tpu_torch.examples.objrender [scene.obj] [out.png] [size]
    python -m nanort_tpu_torch.examples.path_tracer [out.png] [size] [spp]
    python -m nanort_tpu_torch.examples.bidir_path_tracer [out.png] [size] [spp]
    python -m nanort_tpu_torch.examples.gltfrender scene.gltf [out.png] [size]
    python -m nanort_tpu_torch.examples.viewer [seconds] [camera_type]
    python -m nanort_tpu_torch.examples.viewer --http [PORT] [seconds]

Each keeps the JAX program's positional arguments and defaults, and takes
one more option, ``--device cuda|cpu`` (``cuda`` unless asked). Asked
for the card where there is none, a program raises; it never falls back
to the CPU. Each has a ``main(argv=None)`` that returns what it rendered,
so a caller can check it.
"""

from __future__ import annotations

import argparse
import sys

import torch

DEVICES = ("cuda", "cpu")


def parse_device(argv=None) -> tuple[list[str], torch.device]:
    """The program's positional arguments and its ``--device`` (``cuda``
    unless asked), checked: ``cuda`` without a card raises."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", choices=DEVICES, default="cuda")
    ns, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return rest, resolve_device(ns.device)


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; raises ``RuntimeError`` for ``cuda`` when
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "asked for the card, but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (a host clock read after it
    times the work, not its enqueue)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
