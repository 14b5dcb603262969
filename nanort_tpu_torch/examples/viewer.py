"""Live progressive viewer (the port of ``examples/viewer.py``; reference
examples/gui + nanosg viewer architecture, gui/main.cc:106-180): a render
thread accumulates AO passes under the cancel/refresh contract while a
live surface shows them.

Two surfaces replace the reference's ImGui window:

* terminal (default): the accumulating image renders in place as ANSI
  truecolor half-blocks, refreshing every ~0.3 s; half-way the camera
  orbits (RequestRender -> accumulation restarts). Its pass traces the
  BVH16 tables of the Cornell box and a UV sphere through the packet
  kernel's any-hit occlusion route with a per-ray skip (K1 on the card,
  its plain version on the CPU): ``render_ao`` with 2 samples a pass.
* ``--http [PORT]``: a stdlib HTTP page on 127.0.0.1:PORT (0 picks a free
  port; the line it prints names the one bound) with the accumulating
  PNG, the pass counter, Orbit / Restart / Quit buttons and a per-node
  gizmo (reference nanosg/main.cc ImGuizmo): a nudge translates a node,
  re-commits the scene graph (cached mesh BVHs: no rebuild,
  nanosg.h:409-443) and restarts accumulation. Its pass walks the graph
  (``scene_traverse``, the wavefront engine) with a headlight and 2 AO
  samples. Quit ends the program.

    python -m nanort_tpu_torch.examples.viewer [seconds] [camera_type] [--device cuda|cpu]
    python -m nanort_tpu_torch.examples.viewer --http [PORT] [seconds] [--device cuda|cpu]

Random numbers: each pass draws from the ``torch.Generator`` that
``ProgressiveRenderer`` hands it, where the JAX program's pass gets a
threefry key; ``bvh8_pass`` and ``graph_pass`` take the draws, so a test
can pass in the JAX program's.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import BVHBuildOptions, TriangleMesh, build_triangle_bvh, make_rays
from ..build.bvh8 import collapse_bvh8
from ..io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from ..models.cameras import generate_rays, look_at
from ..models.objrender import ao_hemisphere_draws, render_ao
from ..models.progressive import ProgressiveRenderer
from ..scene import matrix as mat
from ..scene.graph import Node, Scene, scene_traverse
from ..utils.image import encode_png, save_png, to_u8
from . import parse_device

SIZE = 128
MAX_PASSES = 128
NODE_NAMES = ("box", "ball_a", "ball_b")
TINT = np.array([[0.9, 0.9, 0.95], [0.95, 0.5, 0.4],
                 [0.4, 0.6, 0.95], [0.8, 0.8, 0.4]], np.float32)


def build_scene(device):
    """The terminal surface's scene: the Cornell box and a 24 x 48 UV
    sphere, built with leaves of 8, its mesh and BVH16 tables on
    ``device``. Returns ``(bvh, mesh, scene8)``."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(24, 48, 0.5))
    bvh, _ = build_triangle_bvh(TriangleMesh(v, f), BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    mesh = TriangleMesh(torch.from_numpy(v).to(device),
                        torch.from_numpy(f).to(device))
    return bvh, mesh, collapse_bvh8(bvh, v, f, width=16).to(device)


def build_scene_graph(device) -> Scene:
    """Named-node scene for the gizmo: a Cornell shell and two movable
    spheres sharing one mesh (reference nanosg obj scenes are also
    multi-node), committed on ``device``."""
    bv, bf = make_cornell_box(2.0)
    sv, sf = make_uv_sphere(20, 40, 0.45)
    sc = Scene(device=device)
    sc.add_node(Node("box", TriangleMesh(bv, bf)))
    ball = TriangleMesh(sv, sf)
    sc.add_node(Node("ball_a", ball, mat.translate((-0.7, -0.6, 0.0))))
    sc.add_node(Node("ball_b", ball, mat.translate((0.7, -0.6, 0.5))))
    sc.commit()
    return sc


def orbit_rays(state: dict, radius: float, cam_type: str, size: int, device):
    """The camera rays of the orbit position in ``state`` (azimuth,
    elevation) at ``radius`` from the origin."""
    az = state["azimuth"]
    el = state.get("elevation", 0.0)
    ce = np.cos(el)
    eye = (radius * ce * np.sin(az), radius * np.sin(el),
           radius * ce * np.cos(az))
    cam = look_at(eye=eye, center=(0, 0, 0), width=size, height=size, fov=60,
                  device=device)
    return generate_rays(cam, cam_type)


def bvh8_pass(bvh, mesh, scene8, rays, draws) -> dict:
    """One AO pass on the BVH16 tables: ``render_ao`` with 2 samples of
    the hemisphere ``draws`` (``(2,) + batch + (3,)``)."""
    aovs, _ = render_ao(bvh, mesh, rays, n_samples=2, max_leaf=8,
                        scene8=scene8, draws=draws)
    return {"rgb": aovs["rgb"]}


def graph_pass(cs, rays, uniforms) -> dict:
    """One pass over the committed graph ``cs``: a headlight and 2 AO
    samples, each offset along the normal in a direction from
    ``uniforms`` ((2, pixels, 3) in [0, 1)), occluded when anything lies
    within 1.2 units. The shading is the JAX program's, in NumPy on the
    host."""
    dev = cs.roots.device
    h = scene_traverse(cs, rays)
    n = h.normal_s.cpu().numpy().reshape(-1, 3)
    d = rays.dir.cpu().numpy().reshape(-1, 3)
    hit = h.hit.cpu().numpy().reshape(-1)
    shade = np.abs((n * -d).sum(-1)) * 0.6 + 0.25
    pos = h.position.cpu().numpy().reshape(-1, 3) + 1e-3 * n
    kk = np.asarray(uniforms, np.float32) - 0.5
    ao = np.zeros(n.shape[0], np.float32)
    for s in range(2):
        w = kk[s] + n * (np.abs(kk[s]).sum(-1, keepdims=True) + 1e-3)
        w /= np.linalg.norm(w, axis=-1, keepdims=True) + 1e-20
        sh = scene_traverse(cs, make_rays(
            torch.from_numpy(pos).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev),
            max_t=torch.from_numpy(
                np.where(hit, 1.2, -1.0).astype(np.float32)).to(dev)))
        ao += 1.0 - sh.hit.cpu().numpy().reshape(-1).astype(np.float32)
    nid = np.minimum(h.node_id.cpu().numpy().reshape(-1), len(TINT) - 1)
    rgb = (shade * (0.35 + 0.65 * ao / 2))[:, None] * TINT[nid]
    rgb = np.where(hit[:, None], rgb, 0.05)
    return {"rgb": rgb.reshape(*rays.batch_shape, 3)}


def make_render_pass(bvh, mesh, scene8, state, cam_type="perspective"):
    """The terminal surface's pass function for ``ProgressiveRenderer``,
    at ``SIZE``^2."""
    def render_pass(p, gen):
        rays = orbit_rays(state, 2.4, cam_type, SIZE, gen.device)
        return bvh8_pass(bvh, mesh, scene8, rays,
                         ao_hemisphere_draws(gen, 2, rays.batch_shape))

    return render_pass


def make_render_pass_sg(state, cam_type="perspective"):
    """The HTTP surface's pass function, at ``SIZE``^2: it reads the
    committed scene from ``state["cs"]``, so a re-commit takes effect at
    the next pass."""
    def render_pass(p, gen):
        rays = orbit_rays(state, 3.4, cam_type, SIZE, gen.device)
        u = torch.rand((2, SIZE * SIZE, 3), generator=gen, device=gen.device)
        return graph_pass(state["cs"], rays, u.cpu().numpy())

    return render_pass


def ansi_frame(rgb, status):
    """Render the image as truecolor half-blocks, two pixels per cell."""
    u8 = to_u8(np.clip(rgb, 0, 1), gamma=2.2)
    h, w, _ = u8.shape
    step = max(1, w // 64)
    rows = []
    for y in range(0, h - step, 2 * step):
        cells = []
        for x in range(0, w, step):
            t = u8[y, x]
            b = u8[y + step, x]
            cells.append(
                f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            )
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows) + f"\n\x1b[0m{status}\n"


def run_terminal(seconds, cam_type, device) -> ProgressiveRenderer:
    """The terminal surface for ``seconds``: AO on the BVH16 tables.
    Writes ``viewer.png`` and returns the stopped renderer
    (``passes_done`` since the orbit's restart, ``pass_times`` of every
    pass)."""
    bvh, mesh, scene8 = build_scene(device)
    state = {"azimuth": 0.0}
    fn = make_render_pass(bvh, mesh, scene8, state, cam_type)
    r = ProgressiveRenderer(fn, max_passes=MAX_PASSES,
                            device=device).start()
    t0 = time.perf_counter()
    orbited = False
    interactive = sys.stdout.isatty()
    try:
        while time.perf_counter() - t0 < seconds:
            time.sleep(0.3)
            if not orbited and time.perf_counter() - t0 > seconds / 2:
                # live scene edit mid-run: orbit the camera and restart
                # accumulation (the reference's RequestRender contract)
                state["azimuth"] = 0.6
                r.request_render()
                orbited = True
            snap = r.snapshot()
            status = (f"pass {r.passes_done}/{MAX_PASSES}"
                      + ("  [orbited: accumulation restarted]"
                         if orbited else ""))
            if snap:
                if interactive:
                    sys.stdout.write("\x1b[H\x1b[2J"
                                     + ansi_frame(snap["rgb"], status))
                else:
                    sys.stdout.write(status + "\n")
                sys.stdout.flush()
    finally:
        r.quit()
    snap = r.snapshot()
    if snap:
        if interactive:
            sys.stdout.write("\x1b[H\x1b[2J" + ansi_frame(snap["rgb"], ""))
        save_png("viewer.png", np.clip(snap["rgb"], 0, 1))
        print(f"wrote viewer.png after {r.passes_done} passes")
    return r


PAGE = b"""<!doctype html><title>nanort_tpu_torch viewer</title>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>nanort_tpu_torch progressive viewer</h3>
<img id=f width=512 height=512 draggable=false
     style="image-rendering:pixelated;cursor:grab;touch-action:none">
<div id=s></div>
<button onclick="fetch('/orbit',{method:'POST'})">Orbit</button>
<button onclick="fetch('/restart',{method:'POST'})">Restart</button>
<button onclick="fetch('/quit',{method:'POST'})">Quit</button>
<div style="margin-top:6px">
node gizmo: <select id=node></select>
<span id=moves></span>
<div>drag the image to orbit; node moves re-commit the scene live</div>
</div>
<script>
async function loadNodes(){
  const ns=await (await fetch('/nodes')).json();
  const sel=document.getElementById('node');
  sel.innerHTML=ns.map(n=>'<option>'+n+'</option>').join('');
  const mv=document.getElementById('moves');
  const axes=[['x',1,0,0],['y',0,1,0],['z',0,0,1]];
  mv.innerHTML=axes.map(a=>
    '<button onclick="moveNode('+a[1]+','+a[2]+','+a[3]+')">+'+a[0]+
    '</button><button onclick="moveNode('+(-a[1])+','+(-a[2])+','+
    (-a[3])+')">-'+a[0]+'</button>').join('');
}
function moveNode(x,y,z){
  const name=document.getElementById('node').value;
  fetch('/node',{method:'POST',body:JSON.stringify(
    {name:name,dx:0.25*x,dy:0.25*y,dz:0.25*z})});
}
loadNodes();
async function tick(){
  document.getElementById('f').src='/frame.png?'+Date.now();
  const st=await (await fetch('/status')).json();
  document.getElementById('s').textContent=
    'pass '+st.passes+'/'+st.max+'  azimuth '+st.azimuth.toFixed(2)+
    '  elevation '+st.elevation.toFixed(2);
}
setInterval(tick, 500); tick();
// drag-to-orbit gizmo: pointer deltas post to /drag, throttled; the
// render thread restarts accumulation per the cancel contract
const img=document.getElementById('f');
let down=false,lx=0,ly=0,ax=0,ay=0,timer=null;
img.addEventListener('pointerdown',e=>{down=true;lx=e.clientX;ly=e.clientY;
  img.setPointerCapture(e.pointerId);});
img.addEventListener('pointerup',()=>{down=false;});
img.addEventListener('pointermove',e=>{
  if(!down)return;
  ax+=e.clientX-lx; ay+=e.clientY-ly; lx=e.clientX; ly=e.clientY;
  if(!timer)timer=setTimeout(()=>{
    fetch('/drag',{method:'POST',body:JSON.stringify({dx:ax,dy:ay})});
    ax=0;ay=0;timer=null;},100);
});
</script>"""


def run_http(port, seconds, device, ready=None) -> ProgressiveRenderer:
    """The HTTP surface on 127.0.0.1:``port`` (0: a free port) until
    ``seconds`` pass or a client posts ``/quit``. ``ready(port)`` is
    called with the bound port before the first request is served.
    Writes ``viewer.png`` and returns the stopped renderer. ``/status``
    also reports ``commits``, the scene's commits so far."""
    sc = build_scene_graph(device)
    lock = threading.Lock()  # one gizmo or drag edit at a time
    state = {"azimuth": 0.0, "elevation": 0.0, "cs": sc.committed,
             "commits": 1}
    stop = threading.Event()
    r = ProgressiveRenderer(make_render_pass_sg(state),
                            max_passes=MAX_PASSES, device=device).start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                snap = r.snapshot()
                img = snap.get("rgb") if snap else None
                if img is None:
                    img = np.zeros((SIZE, SIZE, 3), np.float32)
                self._send(200, "image/png", encode_png(np.clip(img, 0, 1)))
            elif self.path.startswith("/status"):
                body = json.dumps({
                    "passes": r.passes_done, "max": r.max_passes,
                    "azimuth": state["azimuth"],
                    "elevation": state["elevation"],
                    "commits": state["commits"],
                }).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/nodes"):
                self._send(200, "application/json",
                           json.dumps(list(NODE_NAMES)).encode())
            else:
                self._send(200, "text/html", PAGE)

        def do_POST(self):
            if self.path == "/node":
                # the gizmo edit path: translate a named node, re-commit
                # (cached BVHs: matrices only), restart accumulation
                try:
                    d = self._json()
                    with lock:
                        node = sc.find_node(str(d.get("name", "")))
                        if node is not None and node.mesh is not None:
                            node.translate(float(d.get("dx", 0)),
                                           float(d.get("dy", 0)),
                                           float(d.get("dz", 0)))
                            state["cs"] = sc.commit()
                            state["commits"] += 1
                            r.request_render()
                except (ValueError, TypeError):
                    pass
            elif self.path == "/drag":
                try:
                    d = self._json()
                    with lock:
                        state["azimuth"] += 0.01 * float(d.get("dx", 0))
                        state["elevation"] = float(np.clip(
                            state["elevation"] + 0.01 * float(d.get("dy", 0)),
                            -1.4, 1.4))
                        r.request_render()
                except (ValueError, TypeError):
                    pass
            elif self.path == "/orbit":
                with lock:
                    state["azimuth"] += 0.3
                    r.request_render()
            elif self.path == "/restart":
                r.request_render()
            elif self.path == "/quit":
                r.cancel()
                stop.set()
            self._send(200, "text/plain", b"ok")

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    try:
        bound = srv.server_address[1]
        print(f"viewer at http://127.0.0.1:{bound}/ ({seconds:.0f}s)",
              flush=True)
        if ready is not None:
            ready(bound)
        srv.timeout = 0.5
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and not stop.is_set():
            srv.handle_request()
    finally:
        srv.server_close()
        r.quit()
    snap = r.snapshot()
    if snap:
        save_png("viewer.png", np.clip(snap["rgb"], 0, 1))
        print(f"wrote viewer.png after {r.passes_done} passes")
    return r


def main(argv=None) -> ProgressiveRenderer:
    """Run a surface; returns its stopped renderer."""
    args, dev = parse_device(argv)
    if args and args[0] == "--http":
        port = int(args[1]) if len(args) > 1 else 8000
        seconds = float(args[2]) if len(args) > 2 else 30.0
        return run_http(port, seconds, dev)
    seconds = float(args[0]) if args else 5.0
    cam_type = args[1] if len(args) > 1 else "perspective"
    return run_terminal(seconds, cam_type, dev)


if __name__ == "__main__":
    main()
