"""PyTorch port, the loaders (``io/{eson,minecraft,heightmap,displacement,
qrcode,las,partio,ptex}.py``) against the JAX package, on inputs built in
the test (as the JAX package's own loader tests build them; nothing is
read from outside the test's temporary directory).

Tolerance: the NumPy copies (eson, minecraft, heightmap, displacement,
qrcode, and the file I/O of las and partio) give byte- or bit-identical
outputs and files. ``to_spheres`` gives the JAX arrays' bits as tensors.
``ptex.sample`` / ``sample_tri_hits`` are held bit for bit against the
JAX functions run op by op (``jax.disable_jit()``), and each package
reads the other's texture container.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanort_tpu.core.ray import Hits as JHits
from nanort_tpu.io import displacement as jdisp
from nanort_tpu.io import eson as jeson
from nanort_tpu.io import heightmap as jheight
from nanort_tpu.io import las as jlas
from nanort_tpu.io import minecraft as jmc
from nanort_tpu.io import partio as jpartio
from nanort_tpu.io import ptex as jptex
from nanort_tpu.io import qrcode as jqr
from nanort_tpu_torch import Hits, interop
from nanort_tpu_torch.io import (displacement, eson, heightmap, las,
                                 minecraft, partio, ptex, qrcode)
from test_minecraft import _flattened_chunk, _legacy_chunk, _mca, _nbt_blob

torch.set_num_threads(1)


def _same(a, b):
    """Equal structure, dtypes and bits (dicts, lists, tuples, arrays)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


# ------------------------------------------------------------------ eson

def test_eson_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    d = {"answer": 42, "flag": True, "pi": 3.14159, "name": "suzanne",
         "blob": b"\x00\x01\xff", "arr": rng.normal(size=(7, 3)),
         "nested": {"a": np.int64(1), "b": "x", "c": {"d": 2.5}}}
    buf = eson.dumps(d)
    assert buf == jeson.dumps(d)
    _same(eson.loads(buf), jeson.loads(buf))
    v = rng.normal(size=(100, 3)).astype(np.float32)
    f = rng.integers(0, 100, (50, 3)).astype(np.uint32)
    a, b = str(tmp_path / "a.eson"), str(tmp_path / "b.eson")
    eson.save_mesh(a, v, f, generator="nanort_tpu")
    jeson.save_mesh(b, v, f, generator="nanort_tpu")
    assert open(a, "rb").read() == open(b, "rb").read()
    _same(eson.load_mesh(a), jeson.load_mesh(a))


# ------------------------------------------------------------- minecraft

def _region():
    """A region of a legacy chunk (a floor and a pillar) and a flattened
    chunk (stone, air variants, 5-bit indices)."""
    rng = np.random.default_rng(3)
    blocks = np.zeros((16, 16, 16), np.int8)
    blocks[0] = 1
    blocks[1:6, 3, 7] = 2
    idx = (rng.random((16, 16, 16)) < 0.3).astype(np.int64)
    idx[5:7] = 2  # cave air: not solid
    idx[8, 4, 9] = 17
    names = ["minecraft:air", "minecraft:stone", "minecraft:cave_air"] + [
        f"minecraft:b{i}" for i in range(15)]
    return _mca([(0, _legacy_chunk(0, 0, blocks)),
                 (33, _flattened_chunk(1, 1, idx, names, bits=5))])


def test_minecraft_matches_jax():
    data = _region()
    root = {"byte": True, "int": 42, "double": 1.5, "str": "hello",
            "arr": np.arange(8, dtype=np.int8),
            "longs": np.arange(3, dtype=np.int64), "list": [1, 2, 3],
            "nested": {"a": 1}}
    _same(minecraft.parse_nbt(_nbt_blob("root", root)),
          jmc.parse_nbt(_nbt_blob("root", root)))
    _same(minecraft.read_region(data), jmc.read_region(data))
    _same(minecraft.region_to_voxels(data), jmc.region_to_voxels(data))
    v, f = minecraft.load_region_mesh(data, voxel_size=0.5)
    jv, jf = jmc.load_region_mesh(data, voxel_size=0.5)
    _same((v, f), (jv, jf))
    assert len(f) > 0


# ------------------------------------------------- heightmap, displacement

@pytest.mark.parametrize("threshold", [None, 0.4])
def test_heightmap_matches_jax(threshold):
    h = np.random.default_rng(1).random((13, 17)).astype(np.float32)
    _same(heightmap.heightmap_to_mesh(h, 0.5, 2.0, threshold),
          jheight.heightmap_to_mesh(h, 0.5, 2.0, threshold))


@pytest.mark.parametrize("space", ["tangent", "world"])
def test_displacement_matches_jax(space):
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(40, 3, 3)).astype(np.float32)
    uv = rng.random((40, 3, 2)).astype(np.float32)
    uv[3] = uv[3, 0]  # a degenerate UV triangle
    dmap = rng.normal(size=(8, 16, 3)).astype(np.float32)
    _same(displacement.compute_tangent_frames(pos, uv),
          jdisp.compute_tangent_frames(pos, uv))
    _same(displacement.sample_map(dmap, uv.reshape(-1, 2)),
          jdisp.sample_map(dmap, uv.reshape(-1, 2)))
    out = displacement.apply_vector_displacement(pos, uv, dmap, 0.1, space)
    _same(out, jdisp.apply_vector_displacement(pos, uv, dmap, 0.1, space))
    q = np.round(pos * 2) / 2
    for tol in (0.0, 0.25):
        _same(displacement.weld_vertices(q, tol), jdisp.weld_vertices(q, tol))


# ---------------------------------------------------------------- qrcode

@pytest.mark.parametrize("text,level,version", [
    ("HELLO TPU", "M", None), ("nanort-tpu", "H", None),
    ("x" * 200, "L", None), ("v10 " + "y" * 258, "L", None),
    ("", "H", None), ("a", "M", 5)])
def test_qrcode_matches_jax(text, level, version):
    m = qrcode.generate_qr(text, level, version=version)
    _same(m, jqr.generate_qr(text, level, version=version))
    assert qrcode.verify_qr(m) == jqr.verify_qr(m) == text.encode()


def test_qrcode_errors_match_jax():
    for args in (("z" * 5000, "L"), ("a", "X")):
        with pytest.raises(ValueError):
            qrcode.generate_qr(*args)
        with pytest.raises(ValueError):
            jqr.generate_qr(*args)
    m = qrcode.generate_qr("tamper", "M").copy()
    m[m.shape[0] - 2, m.shape[1] - 2] ^= True
    for verify in (qrcode.verify_qr, jqr.verify_qr):
        with pytest.raises(ValueError):
            verify(m)


# ------------------------------------------------------------------- las

def _points(n=500, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [40, 30, 5] + [1e3, 2e3, 10]), rng.random(n)


def test_las_matches_jax(tmp_path):
    pts, inten = _points()
    a, b = str(tmp_path / "a.las"), str(tmp_path / "b.las")
    las.save_las(a, pts, inten)
    jlas.save_las(b, pts, inten)
    assert open(a, "rb").read() == open(b, "rb").read()
    cloud, jcloud = las.load_las(a), jlas.load_las(a)
    _same(tuple(cloud), tuple(jcloud))
    for radius in (None, 0.3):
        s = las.to_spheres(cloud, radius, device="cpu")
        js = jlas.to_spheres(jcloud, radius)
        for x, y in zip(s, js):
            assert x.device.type == "cpu"
            _same(x.numpy(), np.asarray(y))
        t = interop.spheres_from_numpy(*(np.asarray(y) for y in js),
                                       device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(s, t))
    with pytest.raises(ValueError):
        (tmp_path / "bad.las").write_bytes(b"NOPE" + bytes(300))
        las.load_las(str(tmp_path / "bad.las"))


# ---------------------------------------------------------------- partio

def _cloud(cls, n=60, seed=5, attrs=("radius", "id", "velocity")):
    rng = np.random.default_rng(seed)
    every = {"radius": rng.uniform(0.05, 0.2, n).astype(np.float32),
             "pscale": rng.uniform(0.3, 0.4, n).astype(np.float32),
             "id": np.arange(n, dtype=np.int32),
             "velocity": rng.normal(size=(n, 3)).astype(np.float32)}
    return cls(positions=rng.normal(size=(n, 3)).astype(np.float32),
               attributes={k: every[k] for k in attrs})


@pytest.mark.parametrize("fmt", ["pda", "pdb"])
def test_partio_matches_jax(tmp_path, fmt):
    cloud = _cloud(partio.ParticleCloud)
    a, b = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
    getattr(partio, f"save_{fmt}")(a, cloud)
    getattr(jpartio, f"save_{fmt}")(b, _cloud(jpartio.ParticleCloud))
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = partio.load_particles(a), jpartio.load_particles(a)
    _same(got.positions, want.positions)
    _same(got.attributes, want.attributes)


@pytest.mark.parametrize("attrs,radius", [
    (("radius",), None), (("pscale",), None), ((), None), (("radius",), 0.5)])
def test_partio_to_spheres_matches_jax(attrs, radius):
    s = partio.to_spheres(_cloud(partio.ParticleCloud, attrs=attrs), radius,
                          device="cpu")
    js = jpartio.to_spheres(_cloud(jpartio.ParticleCloud, attrs=attrs),
                            radius)
    for x, y in zip(s, js):
        _same(x.numpy(), np.asarray(y))


def test_to_spheres_default_to_the_card():
    for fn in (las.to_spheres, partio.to_spheres, ptex.build_face_textures,
               ptex.load_ptex_npz):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------------ ptex

def _faces(seed=6):
    """Per-face grids at independent power-of-two resolutions."""
    rng = np.random.default_rng(seed)
    res = [(4, 4), (8, 2), (1, 1), (2, 8), (8, 8), (1, 4)]
    return [rng.random((u, v, 3)).astype(np.float32) for u, v in res]


def test_ptex_build_and_container_match_jax(tmp_path):
    faces = _faces()
    tex = ptex.build_face_textures(faces, device="cpu")
    jtex = jptex.build_face_textures(faces)
    for x, y in zip(tex, jtex):
        _same(x.numpy(), np.asarray(y))
    a, b = str(tmp_path / "a.ntpx"), str(tmp_path / "b.ntpx")
    ptex.save_ptex_npz(a, tex)
    jptex.save_ptex_npz(b, jtex)
    for got, want in ((ptex.load_ptex_npz(b, device="cpu"), jtex),
                      (jptex.load_ptex_npz(a), tex)):
        for x, y in zip(got, want):
            _same(np.asarray(x), np.asarray(y))
    t2 = interop.face_textures_from_numpy(*(np.asarray(y) for y in jtex),
                                          device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tex, t2))
    for bad in ([], [np.zeros((3, 4, 3), np.float32)],
                [np.zeros((2, 2, 3), np.float32),
                 np.zeros((2, 2, 1), np.float32)]):
        with pytest.raises(ValueError):
            ptex.build_face_textures(bad, device="cpu")


def test_ptex_sample_bit_for_bit():
    faces = _faces()
    tex = ptex.build_face_textures(faces, device="cpu")
    jtex = jptex.build_face_textures(faces)
    rng = np.random.default_rng(7)
    n = 4096
    fid = rng.integers(-2, len(faces) + 2, n)
    u = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    u[:64] = np.arange(64) / 63.0  # texel edges and centres
    got = ptex.sample(tex, torch.from_numpy(fid), torch.from_numpy(u),
                      torch.from_numpy(v))
    with jax.disable_jit():
        want = np.asarray(jptex.sample(jtex, fid, jnp.asarray(u),
                                       jnp.asarray(v)))
    _same(got.numpy(), want)
    assert (want[(fid < 0) | (fid >= len(faces))] == 0).all()


@pytest.mark.parametrize("quad_faces", [True, False])
def test_ptex_sample_tri_hits_bit_for_bit(quad_faces):
    faces = _faces()
    tex = ptex.build_face_textures(faces, device="cpu")
    jtex = jptex.build_face_textures(faces)
    rng = np.random.default_rng(8)
    n = 2048
    n_tri = 2 * len(faces) if quad_faces else len(faces)
    pid = rng.integers(0, n_tri, n).astype(np.int64)
    pid[::7] = 0xFFFFFFFF
    u = rng.random(n).astype(np.float32)
    v = (rng.random(n) * (1 - u)).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    hits = Hits(*(torch.from_numpy(x) for x in (t, u, v, pid)))
    got = ptex.sample_tri_hits(tex, hits, quad_faces)
    jhits = JHits(jnp.asarray(t), jnp.asarray(u), jnp.asarray(v),
                  jnp.asarray(pid.astype(np.uint32)))
    with jax.disable_jit():
        want = np.asarray(jptex.sample_tri_hits(jtex, jhits, quad_faces))
    _same(got.numpy(), want)
    assert (want[::7] == 0).all()
