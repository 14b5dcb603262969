"""PyTorch port, the example programs and the graft entry
(``nanort_tpu_torch/examples/*.py``, ``nanort_tpu_torch/graft_entry.py``)
against the JAX programs (``examples/*.py``, ``__graft_entry__.py``).

The JAX programs run unchanged through ``runpy`` with a patched
``sys.argv``, jitted in child processes held to AVX
(``testing.run_without_fma``: no FMA contraction), two side by side; the
port's run here on the CPU (``--device cpu``). Both write PNGs into the
test's directory, decoded here with zlib (filter-0 rows, as
``utils/image.py`` writes them). Inputs: the Cornell box with a 16 x 32
UV sphere written as an OBJ, a ``.glb`` of four instances of an 8 x 16
sphere on a ring, 32^2 images.

Tolerances:
- objrender, gltfrender and the graft entry's rgb: the same hit mask
  and u8 within 1 level on every pixel, except (objrender, the entry)
  where the camera ray hits two triangles at the same t, bit for bit:
  the port traces K1's plain version where the JAX programs trace their
  stack engine, and under the equal-t tie contract either triangle's
  record is right, so there each image must show one of the tied
  triangles (rays through the Cornell box's edges tie; at most 5% of
  the pixels);
- path_tracer and bidir_path_tracer (32^2 x 16 spp; threefry against
  ``torch.Generator`` or K3's counter-based generator): per-channel
  image means within 4 standard errors of their difference, the error
  taken from the per-pixel differences (sqrt(sum d^2) / pixels);
- the viewer: one pass of each route with the JAX program's draws passed
  in (the JAX pass's key is ``fold_in(PRNGKey(0), 0)``, as its
  ``ProgressiveRenderer`` hands pass 0), u8 within 1 level; the BVH16
  route through K1's plain version, except where its primary ray ties
  as above (the AO of such a pixel follows the tied triangle's normal).

Port only: each program imports with JAX and the JAX package blocked,
and ``objrender`` runs at its defaults so; ``--device cuda`` raises when
``torch.cuda.is_available()`` is false; the viewer's terminal surface
under two cameras and its HTTP surface on port 0 (page, PNG, status, a
gizmo nudge that re-commits, orbit, quit).
"""

import concurrent.futures
import contextlib
import importlib.util
import io
import json
import math
import os
import runpy
import struct
import subprocess
import sys
import threading
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from nanort_tpu_torch import graft_entry
from nanort_tpu_torch.examples import (bidir_path_tracer, gltfrender,
                                       objrender, parse_device, path_tracer,
                                       viewer)
from nanort_tpu_torch import TriangleMesh
from nanort_tpu_torch.io.obj import load_obj, save_obj
from nanort_tpu_torch.io.procedural import (make_cornell_box, make_uv_sphere,
                                            merge_meshes)
from nanort_tpu_torch.models.objrender import render_ao, render_aovs
from nanort_tpu_torch.testing import ring_glb, run_without_fma

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SPP = 32, 16
CPU = ["--device", "cpu"]
# the JAX programs' argv (after the script) and the children that run them
ARGV = {
    "objrender": ["{dir}/scene.obj", "{dir}/objrender_jax.png", str(SIZE)],
    "path_tracer": ["{dir}/path_tracer_jax.png", str(SIZE), str(SPP)],
    "bidir_path_tracer": ["{dir}/bidir_jax.png", str(SIZE), str(SPP)],
    "gltfrender": ["{dir}/ring.glb", "{dir}/gltfrender_jax.png", str(SIZE)],
}
CHILDREN = (("objrender", "path_tracer", "gltfrender", "graft", "viewer"),
            ("bidir_path_tracer",))
PROGRAMS = ("objrender", "path_tracer", "bidir_path_tracer", "gltfrender",
            "viewer")


def decode_png(path) -> np.ndarray:
    """(H, W, C) uint8 pixels of a PNG of filter-0 rows."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8
        elif tag == b"IDAT":
            idat += body
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (raw[:, 0] == 0).all(), "a row with a filter other than 0"
    return raw[:, 1:].reshape(h, w, c)


def to_u8(img) -> np.ndarray:
    return (np.clip(np.asarray(img, np.float64), 0, 1) * 255 + 0.5).astype(
        np.int64)


def assert_same_image(got, want, hit_mask: bool = True):
    """u8 within 1 level everywhere and, for images black where the ray
    missed, the same hit mask (over 5% of the pixels hit)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    if hit_mask:
        np.testing.assert_array_equal((got > 0).any(-1), (want > 0).any(-1))
        assert (got > 0).any(-1).mean() > 0.05
    assert int(np.abs(got - want).max()) <= 1, np.abs(got - want).max()


def tied_triangles(mesh, rays, hits, pix) -> torch.Tensor:
    """(len(pix), F) mask of the triangles each ray of the flat pixel
    indices ``pix`` hits at the port's t, bit for bit."""
    from nanort_tpu_torch.ops.triangle import (gather_triangle_vertices,
                                               intersect_triangles,
                                               ray_coeffs)

    px = hits.t.numel()
    i = torch.from_numpy(pix)
    org, d, min_t, max_t = (x.reshape((px,) + x.shape[hits.t.ndim:])[i][:, None]
                            for x in rays)
    p0, p1, p2 = gather_triangle_vertices(mesh.vertices, mesh.faces)
    ok, tt, _, _ = intersect_triangles(ray_coeffs(d), org, min_t, max_t,
                                       p0[None], p1[None], p2[None])
    return ok & (tt == hits.t.reshape(px)[i][:, None])


def assert_same_but_ties(got, want, mesh, rays, hits, normals: bool = True):
    """``assert_same_image``, except at pixels whose primary ray hits two
    or more triangles at the port's t, bit for bit (the equal-t tie
    contract: either triangle's record is right; camera rays through the
    box's edges tie), at most 5% of the pixels. On a normal-shaded image
    (``normals``: ``0.5 n + 0.5``, black where the ray missed) both
    images must show one of the tied triangles there; an AO image
    (``normals=False``) depends on the tied triangle's normal and offset
    too, and is not held there."""
    from nanort_tpu_torch.models.objrender import face_normals

    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    if normals:
        np.testing.assert_array_equal((got > 0).any(-1), (want > 0).any(-1))
        assert (got > 0).any(-1).mean() > 0.2
    px = got.shape[0] * got.shape[1]
    bad = np.nonzero((np.abs(got - want).max(-1) > 1).reshape(-1))[0]
    assert len(bad) <= 0.05 * px, len(bad)
    if not len(bad):
        return
    tied = tied_triangles(mesh, rays, hits, bad)
    colors = to_u8((0.5 * face_normals(
        mesh, torch.arange(mesh.faces.shape[0])) + 0.5).numpy())
    for k, pix in enumerate(bad):
        ids = torch.nonzero(tied[k]).flatten().numpy()
        assert len(ids) >= 2, f"pixel {pix} differs without a tie"
        for img in (got, want) if normals else ():
            assert (np.abs(colors[ids] - img.reshape(px, -1)[pix]).max(-1)
                    <= 1).any(), f"pixel {pix}: not a tied triangle's color"


def assert_means_agree(got, want, k: float = 4.0):
    """Per-channel image means within ``k`` standard errors of their
    difference (the error from the per-pixel differences)."""
    d = (np.asarray(got, np.float64) - np.asarray(want, np.float64)
         ).reshape(-1, 3)
    se = np.sqrt((d ** 2).sum(0)) / d.shape[0]
    gap = np.abs(d.mean(0))
    assert (gap <= k * se).all(), (gap, se)
    for img in (got, want):
        assert np.asarray(img, np.float64).mean() > 20.0  # not black


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    save_obj(str(d / "scene.obj"), v, f)
    sv, sf = make_uv_sphere(8, 16, 0.5)
    ring_glb(str(d / "ring.glb"), sv, sf, [  # 4 nodes turned about y
        ((1.5 * math.cos(a), 0.0, 1.5 * math.sin(a)), (0.0, 1.0, 0.0), a)
        for a in np.arange(4) * np.pi / 2])
    return d


@pytest.fixture(scope="module", autouse=True)
def jax_side(workdir):
    """The JAX children's results, waited for at the first call; they
    start with the module's first test and run while the port's tests
    run here."""
    ex = concurrent.futures.ThreadPoolExecutor(len(CHILDREN))
    futs = [ex.submit(run_without_fma, __file__, {
        "dir": np.array(str(workdir)), "jobs": np.array(jobs)})
        for jobs in CHILDREN]
    out = {}

    def result():
        if not out:
            for fu in futs:
                out.update(fu.result())
        return out

    yield result
    for fu in futs:
        fu.result()
    ex.shutdown()


@pytest.mark.parametrize("cam_type", ["perspective", "orthographic"])
def test_viewer_terminal_surface(tmp_path, monkeypatch, cam_type, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(viewer, "SIZE", 16)
    png = tmp_path / "viewer.png"
    r = viewer.run_terminal(1.5, cam_type, torch.device("cpu"))
    printed = capsys.readouterr().out
    assert r._thread is None and len(r.pass_times) >= 1
    assert "pass " in printed and "[orbited: accumulation restarted]" in printed
    if r.passes_done:
        assert decode_png(png).shape == (16, 16, 3)


def test_viewer_http_surface(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(viewer, "SIZE", 16)
    ports, res = [], {}
    ready = threading.Event()

    def serve():
        res["r"] = viewer.run_http(
            0, 120, torch.device("cpu"),
            ready=lambda p: (ports.append(p), ready.set()))

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert ready.wait(60)
    base = f"http://127.0.0.1:{ports[0]}"

    def call(path, body=None):
        req = urllib.request.Request(
            base + path, data=None if body is None else json.dumps(
                body).encode(), method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            return resp.read()

    assert b"progressive viewer" in call("/")
    frame = tmp_path / "frame.png"
    frame.write_bytes(call("/frame.png"))
    assert decode_png(frame).shape == (16, 16, 3)
    assert json.loads(call("/nodes")) == ["box", "ball_a", "ball_b"]
    st = json.loads(call("/status"))
    assert st["commits"] == 1 and st["max"] == 128
    call("/node", {"name": "ball_a", "dx": 0.25, "dy": 0, "dz": 0})
    call("/node", {"name": "no_such_node", "dx": 0.25})
    call("/orbit", {})
    st = json.loads(call("/status"))
    assert st["commits"] == 2 and st["azimuth"] == pytest.approx(0.3)
    call("/quit", {})
    th.join(60)
    assert not th.is_alive() and res["r"]._thread is None


@pytest.mark.parametrize("module", [
    f"nanort_tpu_torch.examples.{p}" for p in PROGRAMS]
    + ["nanort_tpu_torch.graft_entry"])
def test_imports_without_jax(module):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nanort_tpu'] = None\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nanort_tpu') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


def test_objrender_defaults_without_jax(tmp_path):
    """``objrender`` with no arguments (the procedural scene at 512^2,
    ``objrender.png``) in a process where JAX cannot be imported."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['nanort_tpu'] = None\n"
            "import torch\n"
            "torch.set_num_threads(2)\n"
            "from nanort_tpu_torch.examples import objrender\n"
            "objrender.main(['--device', 'cpu'])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "% hit)" in r.stdout
    img = decode_png(tmp_path / "objrender.png")
    assert img.shape == (512, 512, 3) and (img > 0).any(-1).mean() > 0.3


@pytest.mark.parametrize("prog", PROGRAMS + ("graft_entry",))
def test_cuda_without_a_card_raises(monkeypatch, tmp_path, prog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = {"objrender": [], "path_tracer": ["a.png", "8", "1"],
            "bidir_path_tracer": ["a.png", "8", "1"],
            "gltfrender": ["none.glb"], "viewer": ["0.1"],
            "graft_entry": []}[prog]
    mod = graft_entry if prog == "graft_entry" else importlib.import_module(
        f"nanort_tpu_torch.examples.{prog}")
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(argv)
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(argv + ["--device", "cuda"])
    if prog == "graft_entry":
        with pytest.raises(RuntimeError, match="is_available"):
            graft_entry.entry()
    assert not os.listdir(tmp_path)


def test_parse_device():
    assert parse_device(["a", "--device", "cpu"]) == (["a"], torch.device(
        "cpu"))
    assert parse_device(["--device=cpu", "--http", "0", "5"]) == (
        ["--http", "0", "5"], torch.device("cpu"))
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        parse_device(["--device", "tpu"])


# ---- against the JAX programs (after the port-only tests, which run
# while the JAX children work)


def test_objrender_matches_jax(workdir, jax_side, capsys):
    got = objrender.main([str(workdir / "scene.obj"),
                          str(workdir / "objrender.png"), str(SIZE)] + CPU)
    printed = capsys.readouterr().out
    for line in ("BVH build time", "# of leaf   nodes", "BVH16 tables",
                 "Render", "% hit)"):
        assert line in printed
    assert got["rgb"].shape == (SIZE, SIZE, 3)
    assert set(got["seconds"]) == {"load", "build", "tables", "render"}
    m = load_obj(str(workdir / "scene.obj"))
    mesh = TriangleMesh(torch.from_numpy(m.vertices),
                        torch.from_numpy(m.faces))
    jax_side()
    assert_same_but_ties(decode_png(workdir / "objrender.png"),
                         decode_png(workdir / "objrender_jax.png"), mesh,
                         got["rays"], got["hits"])


def test_graft_entry_matches_jax(jax_side):
    fn, args = graft_entry.entry(device="cpu")
    assert args[2].org.shape == (16, 16, 3) and args[3].width == 16
    rgb = fn(*args)
    assert rgb.device.type == "cpu"
    aovs, hits = render_aovs(*args[:3], scene8=args[3])
    assert torch.equal(aovs["rgb"], rgb)
    assert_same_but_ties(to_u8(rgb.numpy()), to_u8(jax_side()["graft/rgb"]),
                         args[1], args[2], hits)


def test_graft_dryrun_is_the_port_s():
    from nanort_tpu_torch.parallel import dryrun

    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip


@pytest.mark.parametrize("prog", ["path_tracer", "bidir_path_tracer"])
def test_path_tracers_match_jax(workdir, jax_side, prog):
    mod = {"path_tracer": path_tracer,
           "bidir_path_tracer": bidir_path_tracer}[prog]
    png = workdir / f"{prog}.png"
    got = mod.main([str(png), str(SIZE), str(SPP)] + CPU)
    assert got["img"].shape == (SIZE, SIZE, 3)
    assert bool(torch.isfinite(got["img"]).all())
    jax_side()
    want = ARGV[prog][0].format(dir=workdir)
    assert_means_agree(decode_png(png), decode_png(want))


def test_gltfrender_matches_jax(workdir, jax_side, capsys):
    png = workdir / "gltfrender.png"
    got = gltfrender.main([str(workdir / "ring.glb"), str(png), str(SIZE)]
                          + CPU)
    assert "1 meshes, 4 instances" in capsys.readouterr().out
    assert set(got["seconds"]) == {"commit", "walk"}
    jax_side()
    assert_same_image(decode_png(png),
                      decode_png(workdir / "gltfrender_jax.png"))


def test_gltfrender_without_a_scene_prints_its_usage(capsys):
    assert gltfrender.main(CPU) is None
    assert "scene.gltf" in capsys.readouterr().out


def test_viewer_bvh8_pass_matches_jax(jax_side):
    """One pass of the terminal surface's route through K1's plain
    version, with the JAX pass's hemisphere draws."""
    out = jax_side()
    dev = torch.device("cpu")
    bvh, mesh, s8 = viewer.build_scene(dev)
    rays = viewer.orbit_rays({"azimuth": 0.0}, 2.4, "perspective", SIZE, dev)
    draws = torch.from_numpy(out["viewer/bvh8/draws"])
    got = viewer.bvh8_pass(bvh, mesh, s8, rays, draws)
    aovs, hits = render_ao(bvh, mesh, rays, n_samples=2, max_leaf=8,
                           scene8=s8, draws=draws)
    assert torch.equal(aovs["rgb"], got["rgb"])
    assert_same_but_ties(to_u8(got["rgb"].numpy()),
                         to_u8(out["viewer/bvh8/rgb"]), mesh, rays, hits,
                         normals=False)


def test_viewer_graph_pass_matches_jax(jax_side):
    """One pass of the HTTP surface's route (the graph walk) with the JAX
    pass's uniforms."""
    out = jax_side()
    dev = torch.device("cpu")
    cs = viewer.build_scene_graph(dev).committed
    rays = viewer.orbit_rays({"azimuth": 0.0, "elevation": 0.0}, 3.4,
                             "perspective", SIZE, dev)
    got = viewer.graph_pass(cs, rays, out["viewer/graph/uniforms"])
    assert_same_image(to_u8(got["rgb"]), to_u8(out["viewer/graph/rgb"]),
                      hit_mask=False)


def _jax_viewer_passes(size):
    """The JAX viewer's two pass functions, pass 0, at ``size``^2."""
    import jax
    import jax.numpy as jnp
    from nanort_tpu.models.objrender import ao_hemisphere_draws

    spec = importlib.util.spec_from_file_location(
        "jax_viewer", os.path.join(ROOT, "examples", "viewer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SIZE = size
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    bvh, mesh, s8 = mod.build_scene()
    rp = mod.make_render_pass(bvh, mesh, s8, {"azimuth": 0.0})
    sc = mod.build_scene_graph()
    sg = mod.make_render_pass_sg(
        sc, {"azimuth": 0.0, "elevation": 0.0, "cs": sc.committed})
    return {
        "viewer/bvh8/rgb": np.asarray(rp(0, key)["rgb"]),
        "viewer/bvh8/draws": np.asarray(ao_hemisphere_draws(
            key, 2, (size, size), jnp.float32)),
        "viewer/graph/rgb": np.asarray(sg(0, key)["rgb"]),
        "viewer/graph/uniforms": np.asarray(jax.random.uniform(
            key, (2, size * size, 3))),
    }


def _jax_side(inp, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    z = dict(np.load(inp))
    d = str(z["dir"])
    os.chdir(d)
    res = {"done": np.int64(1)}
    for job in map(str, z["jobs"]):
        if job == "graft":
            sys.path.insert(0, ROOT)
            import __graft_entry__

            fn, args = __graft_entry__.entry()
            res["graft/rgb"] = np.asarray(jax.jit(fn)(*args))
        elif job == "viewer":
            res.update(_jax_viewer_passes(SIZE))
        else:
            argv = [a.format(dir=d) for a in ARGV[job]]
            sys.argv = [job + ".py"] + argv
            with contextlib.redirect_stdout(io.StringIO()):
                runpy.run_path(os.path.join(ROOT, "examples", job + ".py"),
                               run_name="__main__")
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
