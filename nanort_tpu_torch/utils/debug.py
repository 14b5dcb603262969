"""Debug / sanitizer utilities (port of ``nanort_tpu.utils.debug``;
reference §5 aux: ASan/TSan cmake modules, FP-exception trapping in the
BPT example, -Weverything builds).

NaN trapping (``trap_nans``, a torch dispatch mode where the JAX package
sets ``jax_debug_nans``), host-side input validation for ray batches,
and finite-output assertions for renders. The checks take tensors on any
device: they fetch what they read to the host, and only for the check.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops whose output is uninitialised memory, which may hold NaN bits that
# no computation made
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "set_"}


def _any_nan(tree) -> bool:
    for x in tree_flatten(tree)[0]:
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.device.type != "meta" and x.numel()
                and bool(torch.isnan(x).any())):
            return True
    return False


class _NanTrap(TorchDispatchMode):
    """Raises FloatingPointError when an op's output holds a NaN that none
    of its inputs held (read before the op runs, so an in-place op that
    makes a NaN is caught too)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return func(*args, **kwargs)
        before = _any_nan((args, kwargs))
        out = func(*args, **kwargs)
        if not before and _any_nan(out):
            raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def trap_nans():
    """Trap NaNs made by torch ops within the scope (the BPT example's
    feenableexcept equivalent, bidir_path_tracer/main.cc:26-35; the JAX
    package sets ``jax_debug_nans`` here).

    Every torch op dispatched inside the scope, on any device, is checked
    after it runs: when its output holds a NaN that its inputs did not,
    it raises ``FloatingPointError`` naming the op. NaNs carried in from
    outside pass through ops without raising. Each check reads a flag
    back to the host, so the scope runs slower and synchronises the
    card after every op.

    What it cannot see: the insides of the hand-written CUDA kernels,
    which the port launches through ctypes and not as torch ops. A NaN
    that a kernel writes goes unseen, and a later op that reads it is
    exempt. NumPy code on the host is not seen either."""
    with _NanTrap():
        yield


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_rays(rays, allow_zero_dir: bool = True) -> None:
    """Host-side sanity checks on a ray batch (tensors on any device are
    fetched to the host); raises ValueError with a count + first
    offending index."""
    org = _host(rays.org)
    d = _host(rays.dir)
    if org.shape != d.shape or org.shape[-1] != 3:
        raise ValueError(f"org/dir shapes {org.shape} vs {d.shape}")
    bad = ~np.isfinite(org).all(-1) | ~np.isfinite(d).all(-1)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"{bad.sum()} non-finite rays (first at {i})")
    if not allow_zero_dir:
        zero = (d == 0).all(-1)
        if zero.any():
            i = int(np.flatnonzero(zero)[0])
            raise ValueError(f"{zero.sum()} zero-direction rays (first at {i})")
    mn = _host(rays.min_t)
    mx = _host(rays.max_t)
    if (mn > mx).any():
        raise ValueError("min_t > max_t for some rays")


def assert_finite_image(img, name: str = "image") -> None:
    """Raise AssertionError when ``img`` (a tensor on any device or an
    array) holds a NaN or an infinity."""
    a = _host(img)
    if not np.isfinite(a).all():
        n = (~np.isfinite(a)).sum()
        raise AssertionError(f"{name}: {n} non-finite values")
