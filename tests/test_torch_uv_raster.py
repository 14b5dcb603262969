"""PyTorch port, UV-atlas rasterization (``models/uv_raster.py``) against
the JAX package on the same meshes, UV layouts and attributes.

The JAX ``rasterize_uv_atlas`` runs in a child process held to AVX
(``testing.run_without_fma``; its stack traversal is jitted, which on
the CPU contracts FMAs otherwise). Cases: a UV sphere whose triangles
sit in their own atlas cells (with facevarying normals baked as an
attribute), the same at a zoomed ``uv_region``, and a two-triangle quad
covering the atlas. Tolerance: ``make_uv_mesh`` identical arrays;
``prim_id``, ``position`` and every attribute bit-identical.
"""

import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch.io.procedural import make_uv_sphere
from nanort_tpu_torch.models import uv_raster
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)


def _cases():
    """name -> (vertices, faces, facevarying uvs, atlas size, uv region,
    attributes)."""
    v, f = make_uv_sphere(6, 12, 1.0)
    n = len(f)
    cells = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(3)
    corner = np.stack([np.arange(n) % cells, np.arange(n) // cells], 1)
    tri = np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9]])
    uvs = ((corner[:, None, :] + tri[None] * rng.uniform(0.7, 1.0, (n, 1, 1)))
           / cells).astype(np.float32)
    nrm = v[f] / np.linalg.norm(v[f], axis=-1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    attrs = {"normal": nrm.astype(np.float32), "col": col}
    qv = np.array([[0, 0, 0], [2, 0, 0], [2, 2, 1], [0, 2, 1]], np.float32)
    qf = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    quv = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                   np.float32)
    return {
        "sphere": (v, f, uvs, 48, ((0.0, 0.0), (1.0, 1.0)), attrs),
        "sphere_zoom": (v, f, uvs, 32, ((0.25, 0.1), (0.75, 0.6)), attrs),
        "quad": (qv, qf, quv, 24, ((0.0, 0.0), (1.0, 1.0)), {}),
    }


@pytest.fixture(scope="module")
def jax_side():
    return run_without_fma(__file__, {"dummy": np.zeros(1)})


@pytest.mark.parametrize("case", list(_cases()))
def test_rasterize_uv_atlas_matches_jax(jax_side, case):
    v, f, uvs, size, region, attrs = _cases()[case]
    out = uv_raster.rasterize_uv_atlas(
        TriangleMesh(torch.from_numpy(v), torch.from_numpy(f)), uvs, size,
        region, attrs, device="cpu")
    assert set(out) == {"prim_id", "position", *attrs}
    pid = out["prim_id"].numpy()
    assert (pid != 0xFFFFFFFF).any()
    if case == "quad":
        assert (pid != 0xFFFFFFFF).all()
    for k, x in out.items():
        np.testing.assert_array_equal(x.numpy(), jax_side[f"{case}/{k}"],
                                      err_msg=k)


def test_make_uv_mesh_matches_jax():
    from nanort_tpu.models import uv_raster as juv

    uvs = _cases()["sphere"][2]
    a, b = uv_raster.make_uv_mesh(uvs), juv.make_uv_mesh(uvs)
    for x, y in zip(a, b):
        assert x.dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, np.asarray(y))


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from nanort_tpu.models import uv_raster as juv
    from nanort_tpu.ops.triangle import TriangleMesh as JMesh

    res = {}
    for name, (v, f, uvs, size, region, attrs) in _cases().items():
        o = juv.rasterize_uv_atlas(JMesh(jnp.asarray(v), jnp.asarray(f)),
                                   uvs, size, region, attrs)
        for k, x in o.items():
            x = np.asarray(x)
            res[f"{name}/{k}"] = x.astype(np.int64) if k == "prim_id" else x
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
