"""Wide-BVH traversal of coherent ray batches (port of the public surface
of ``nanort_tpu.traverse.pallas_packet``).

``traverse_bvh8`` traces rays through the BVH8/BVH16 tables of
``build.bvh8.collapse_bvh8``: closest-hit or any-hit (``occlusion``),
the watertight intersector with the Dekker exact-edge fallback or the
Woop unit-triangle test (``intersector="woop"``, over ``leafs_woop``),
or, for a scene of sphere leaf rows (``scene.leaf_kind == "sphere"``),
the sphere test of ``ops/sphere.py``, and the skip / prim-range /
back-face filters. On CUDA tensors it
launches the hand-written kernel ``csrc/packet_traverse.cu``: persistent
warps that claim 32 consecutive rays at a time from a counter, one ray a
lane, each with its own stack in local memory (``launch_plan`` sizes the
grid from the card's occupancy). On CPU tensors it runs
``_traverse_reference``, the plain torch version of the same per-ray
traversal — the same pops in the same order and the same arithmetic, so
the two agree bit for bit.

Equal-t ties: the last equal-t hit in this per-ray near-first order
wins. The TPU kernel's order is packet-granular, so ``prim_id`` may
legally differ from the JAX package's at exactly equal t.

The TPU kernel's other modes are the same kernel's: per-packet start
nodes (``packet_roots``, the treelet engine's), visit counters
(``debug_counts``, per ray here), zero-edge flags (``_flag_zero_edges``,
the first pass of ``traverse_bvh8_exact`` and ``_exact_fused``) and
``interleave`` (K1b: the caller's schedule for incoherent batches,
claims of 32 K rays refilling idle lanes; ``launch_plan``). Its TPU
memory and scheduling knobs (``scene_space``, ``vmem_mb``, ``node_split``/``leaf_split``,
``frustum``, ``pop_n``/``lq_cap``, ``t_sync_every``, ``refit_inkernel``,
``_oracle_t``) have no counterpart and are not taken.
"""

from __future__ import annotations

import dataclasses

import torch

from ..build.bvh8 import BVH8Scene
from ..core.math import safe_inverse
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID, PRIM_RANGE_MAX
from ..core.ray import PRIM_ID_DTYPE, Hits, Rays
from ..ops.curve import _project, _z_align, curve_hit
from ..ops.sphere import sphere_hit
from ..ops.triangle import (RayCoeffs, TriangleMesh, intersect_triangles,
                            ray_coeffs)
from ..utils import trace
from . import _ext

LANES = 128
DEF_SUB = 32  # rays per packet / LANES in the TPU kernel (specialization)
STACK_CAP = 512  # kStackCap in csrc/packet_traverse.cu
IL_MAX_RAYS = 2**31 - 1  # K1b indexes rays with 32-bit ints
BIG = 3.0e38  # degenerate-ray threshold
MAX_MULT = 1.00000024  # 4-ulp exit-plane multiplier (core/aabb.max_mult)

# Kernel launches made by traverse_bvh8 (never by the plain version),
# counted in utils.trace, one key a launch: the mode it ran in
# ("[interleave=K]", "[counts]", "[flags]", else "[roots]" when it had
# packet roots), or else its leaf test: "packet_traverse" (watertight),
# "packet_traverse_woop", "packet_traverse[sphere]",
# "packet_traverse[curve]"; "k1.rays" adds each launch's rays.
LAUNCH_KEYS = ("packet_traverse", "packet_traverse_woop",
               "packet_traverse[roots]", "packet_traverse[counts]",
               "packet_traverse[flags]", "packet_traverse[interleave=2]",
               "packet_traverse[interleave=4]", "packet_traverse[sphere]",
               "packet_traverse[curve]")
trace.declare_launches(*LAUNCH_KEYS)
trace.count("k1.rays", 0)
INTERSECTORS = ("watertight", "woop")
# K1's launch (csrc/packet_traverse.cu: kThreads, kClaim): blocks of
# K1_THREADS threads, each warp claiming K1_CLAIM consecutive rays at a
# time
K1_THREADS = 128
K1_CLAIM = 32
INTERLEAVES = (1, 2, 4)
WOOP_MAX_LEAF = 9  # 12 lanes a triangle + the prim-id block at lane 108
SPHERE_MAX_LEAF = 10  # 4 lanes a sphere + the prim-id block at lane 108
CURVE_MAX_LEAF = 6  # 16 lanes a curve + the prim-id block at lane 108
# the kernel's leaf tests (kTriangle, kWoop, kSphere, kCurve in the source)
LEAF_TRIANGLE, LEAF_WOOP, LEAF_SPHERE, LEAF_CURVE = 0, 1, 2, 3
LEAF_OF_KIND = {"triangle": LEAF_TRIANGLE, "sphere": LEAF_SPHERE,
                "curve": LEAF_CURVE}


def _leaf(woop: bool, kind: str) -> int:
    """The leaf test of a scene of ``leaf_kind`` ``kind`` (Woop's)."""
    return LEAF_WOOP if woop else LEAF_OF_KIND[kind]


def stack_slots(scene: BVH8Scene) -> int:
    """Per-ray stack entries that can never overflow for ``scene``.

    The TPU kernel sizes its shared packet stack from ``scene.depth`` and
    ``width`` (pallas_packet.py:2239-2245); a private near-first stack
    needs less: popping a node pushes at most ``width`` children and one
    of them is popped next, so each of the ``depth`` node levels leaves
    at most ``width - 1`` entries behind, plus one for the deepest
    level's last child."""
    return scene.depth * (scene.width - 1) + 1


def k1b_claims(n_rays: int, packets: int) -> int:
    """K1b's claims for ``n_rays`` rays (csrc/packet_traverse.cu
    ``claims_of``): claims of ``packets`` packets of 32 rays, four of
    them tiling each ``128 * packets`` consecutive rays, packet k of a
    claim 128 rays after packet k - 1, so the last four claims may hold
    rays past ``n_rays``, which the kernel skips."""
    return -(-n_rays // (K1_THREADS * packets)) * (K1_THREADS // 32)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One K1 or K1b launch: ``grid`` persistent blocks of ``threads``
    threads, warps claiming ``claim`` rays at a time (32 for K1; for K1b
    K packets of 32, or one on an any-hit launch)."""
    grid: int
    threads: int
    claim: int


def launch_plan(n_rays: int, blocks_per_sm: int, sms: int,
                interleave: int = 1, occlusion: bool = False) -> LaunchPlan:
    """The launch of K1 (``interleave=1``) or K1b for ``n_rays`` rays: the
    blocks that stay resident (``blocks_per_sm`` from the occupancy API
    of the instantiation, times ``sms``), or fewer when the batch has
    fewer claims than that grid has warps. Each warp claims ``claim``
    rays at a time until the counter passes the batch. K1b claims K
    packets of 32 rays, one packet on an any-hit launch, whose claims it
    walks as K1 walks them (on an H100, claims of K packets measured
    faster on sorted closest-hit bounce rays and slower on any-hit rays:
    PERF.md §6)."""
    if blocks_per_sm < 1:
        raise ValueError(f"K1 does not fit an SM: {blocks_per_sm} blocks")
    packets = 1 if interleave == 1 or occlusion else interleave
    blocks = -(-n_rays // (K1_THREADS * packets))
    return LaunchPlan(max(1, min(blocks_per_sm * sms, blocks)), K1_THREADS,
                      K1_CLAIM * packets)


def k1_occupancy(width: int, woop: bool = False, counts: bool = False,
                 flags: bool = False, roots: bool = False,
                 device=None, interleave: int = 1,
                 kind: str = "triangle") -> dict:
    """What the card's occupancy API and the compiled kernel say of one K1
    instantiation (``kind``: the leaf test of a scene of that
    ``leaf_kind``, Woop with ``woop``), or with
    ``interleave`` 2 or 4 of the K1b one: resident ``blocks_per_sm``,
    ``registers`` and ``local_bytes`` (the stack frame) a thread,
    ``shared_bytes`` a block, ``threads`` a block and rays a ``claim``,
    and the card's ``sms``. Cached per device."""
    if interleave not in INTERLEAVES:
        raise ValueError(f"interleave must be 1, 2 or 4: {interleave}")
    return _ext.occupancy(
        "packet_traverse", "nrt_packet_traverse_occupancy",
        ("blocks_per_sm", "registers", "local_bytes", "shared_bytes",
         "threads", "claim"), width, _leaf(woop, kind), int(counts),
        int(flags), int(roots), interleave, device=device)


def _check_overflow(err: torch.Tensor, slots: int) -> None:
    """Fail the stream when the kernel set its overflow word (checked on
    the stream, without a host sync: an overflow can only come from a
    scene.depth that BVH8Scene.to did not check, or a root deeper than
    it, and it fails the next synchronising call)."""
    torch._assert_async(
        err == 0, f"traversal stack overflow ({slots} slots): "
        "scene.depth does not describe the tables")


def _well_formed(org: torch.Tensor, dir: torch.Tensor) -> torch.Tensor:
    """Rays the kernel traces; the rest (NaN/inf or |x| >= 3e38 origin or
    direction, zero direction) are degenerate and must miss
    (pallas_packet.py:138-162)."""
    return ((org.abs() < BIG).all(1) & (dir.abs() < BIG).all(1)
            & (dir.abs().sum(1) > 0))


def _check_specialize(specialize):
    """Validate ``specialize`` as the JAX package does
    (pallas_packet.py:2007-2018). Its rewrites are bit-exact, so this
    port accepts them and runs the general kernel."""
    if specialize is None:
        return
    kz_static = (tuple(specialize) + (False,))[0]
    if kz_static not in (None, 0, 1, 2):
        raise ValueError(f"kz_static must be None/0/1/2: {kz_static}")


def _table(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"scene tables are on {x.device}, rays on {device}: move "
                "the scene with scene.to(device)")
        return x
    if device.type != "cpu":
        raise ValueError("scene tables are host arrays: move them with "
                         "scene.to(device)")
    return torch.as_tensor(x)


def _flat(x: torch.Tensor, trailing: tuple, name: str) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError(f"rays.{name} must be contiguous")
    return x.view((-1,) + trailing)


@trace.span("k1")
def traverse_bvh8(scene: BVH8Scene, rays: Rays,
                  options: BVHTraceOptions = BVHTraceOptions(),
                  skip_prim_id=None, occlusion: bool = False,
                  specialize: tuple | None = None,
                  intersector: str = "watertight", sub: int = DEF_SUB,
                  packet_roots=None, debug_counts: bool = False,
                  interleave: int = 1, _flag_zero_edges: bool = False):
    """Trace ``rays`` against a BVH8/BVH16 scene (float32).

    ``occlusion=True`` is the any-hit mode: each ray stops at its first
    accepted hit and reports that hit (t is its distance, not
    necessarily the closest). ``skip_prim_id`` is an optional per-ray
    tensor overriding ``options.skip_prim_id``. ``specialize`` is
    accepted for API parity (``detect_specialization``) and validated.

    ``intersector="woop"`` tests the triangles of ``scene.leafs_woop``
    (``collapse_bvh8(..., woop=True)``, at most 9 a row) with the Woop
    unit-triangle test (pallas_packet.py:283-332) in place of the
    watertight one; it has no edge functions, so ``exact_edge_fallback``
    does not apply. Its records may differ from the watertight ones
    within an ulp of an edge (a hit against a miss, or the neighbouring
    prim), the JAX package's own contract for it.

    Rays keep their batch shape. Misses report ``t = max_t`` (``+inf``
    for degenerate rays in closest-hit mode), ``u = v = 0`` and
    ``prim_id = 0xFFFFFFFF``. Rays with an empty interval
    (``max_t < min_t``) or a NaN bound cannot hit and retire before
    their first node.

    The modes of the TPU kernel (pallas_packet.py:2183-2307):

    - ``packet_roots``: one start node row per packet of ``sub * 128``
      consecutive rays (``ceil(R / (sub * 128))`` of them, int), in place
      of the root row 0. Each root's subtree must fit the stack that
      ``scene.depth`` sizes (``treelet.make_treelets`` checks its roots).
    - ``debug_counts=True``: ``u`` and ``v`` carry each ray's node pops
      and leaf pops as floats; ``t`` and ``prim_id`` are the records.
      The TPU kernel counts per packet and writes the packet's counts to
      every ray; this kernel walks one ray a thread, so its counters are
      per ray (a deliberate deviation).
    - ``_flag_zero_edges=True`` returns ``(hits, flags)``: an int32 a
      ray, 1 where the ray tested a triangle whose U, V or W was 0 before
      any exact recompute. Every ray whose record could change with the
      recompute is flagged. Needs the watertight test.
    - ``interleave=K`` (1, 2 or 4; K1b): the same records as
      ``interleave=1``, under the schedule for incoherent batches. Warps
      claim 32 K rays at a time; where the claim's rays do not share one
      origin (bounce, shadow or random rays), a lane whose ray ended
      takes the claim's next ray as soon as 16 lanes of its warp are
      free, where K1 waits for the longest walk of its 32. A camera's
      rays are walked as K1 walks them, and an any-hit launch takes K1's
      claims of 32 rays too. Pass it for incoherent closest-hit batches
      (on an H100 1.2-1.5x faster than ``interleave=1`` on random and
      sorted bounce rays, slower on a camera frame: PERF.md §6). Needs
      fewer than 2^31 rays. The kernel
      implements it without ``debug_counts`` and ``_flag_zero_edges``;
      those combinations raise (the JAX package warns and falls back to
      1).

    ``sub`` only groups rays into packets for ``packet_roots``.

    A sphere scene (``collapse_bvh8(..., spheres=)``, ``scene.leaf_kind
    == "sphere"``) takes the sphere test of ``ops/sphere.py``, its t bit
    for bit, with u = v = 0 (``ops.sphere.sphere_post`` fills them), the
    skip and range filters and the modes above but ``_flag_zero_edges``
    and ``interleave`` > 1; spheres have no back face and no edges, so
    ``cull_back_face`` and ``exact_edge_fallback`` do not apply, and the
    intersector stays "watertight". A curve scene (``collapse_bvh8(...,
    curves=)``, ``"curve"``) takes the curve test of ``ops/curve.py``
    (``curve_hit``, 4 spans) under the same rules, its t, u (the curve
    parameter) and v (the distance to the curve's axis) bit for bit;
    of a leaf's curves at exactly equal t the first wins.
    """
    _check_specialize(specialize)
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}")
    woop = intersector == "woop"
    kind = scene.leaf_kind
    sphere, curve = kind == "sphere", kind == "curve"
    if kind != "triangle" and (woop or _flag_zero_edges or interleave > 1):
        raise ValueError(f"a {kind} scene takes the {kind} test without "
                         "intersector='woop', _flag_zero_edges and "
                         "interleave")
    exact_edge = (options.exact_edge_fallback and not woop
                  and kind == "triangle")
    if interleave not in INTERLEAVES:
        raise ValueError(f"interleave must be 1, 2 or 4: {interleave}")
    if interleave > 1 and rays.org.numel() // 3 > IL_MAX_RAYS:
        raise ValueError(f"the interleaved kernel takes at most "
                         f"{IL_MAX_RAYS} rays a launch")
    if interleave > 1 and (debug_counts or _flag_zero_edges):
        raise ValueError("the interleaved kernel runs without debug_counts "
                         "and _flag_zero_edges")
    if debug_counts and _flag_zero_edges:
        raise ValueError("debug_counts and _flag_zero_edges are separate "
                         "kernels: ask for one")
    if _flag_zero_edges and woop:
        raise ValueError("flag_zero_edges requires the watertight "
                         "intersector")
    if int(sub) != sub or sub < 1:
        raise ValueError(f"sub must be a positive int: {sub}")
    if woop:
        if scene.leafs_woop is None:
            raise ValueError(
                "intersector='woop' needs the Woop leaf table: build the "
                "scene with collapse_bvh8(..., woop=True)")
        if scene.max_leaf > WOOP_MAX_LEAF:
            raise ValueError("woop rows hold <= 9 triangles; rebuild "
                             "with max_leaf_primitives<=9")
    if scene.width not in (8, 16):
        raise ValueError(f"width must be 8 or 16: {scene.width}")
    slots = stack_slots(scene)
    if slots > STACK_CAP:
        raise ValueError(f"scene depth {scene.depth} needs {slots} stack "
                         f"slots, the kernel holds {STACK_CAP}")
    bs = rays.batch_shape
    dev = rays.org.device
    for name in ("org", "dir", "min_t", "max_t"):
        x = getattr(rays, name)
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"rays.{name} must be float32 on {dev}")
    org = _flat(rays.org, (3,), "org")
    dir = _flat(rays.dir, (3,), "dir")
    min_t = _flat(rays.min_t, (), "min_t")
    max_t = _flat(rays.max_t, (), "max_t")
    n = org.shape[0]
    nodes = _table(scene.nodes, dev)
    # woop rows pair one to one with the watertight leaf rows
    leafs = _table(scene.leafs_woop if woop else scene.leafs, dev)
    for name, tab in (("nodes", nodes), ("leafs", leafs)):
        if (tab.dtype != torch.float32 or tab.ndim != 2
                or tab.shape[1] != LANES or not tab.is_contiguous()):
            raise ValueError(f"scene.{name} must be contiguous float32 "
                             f"(rows, {LANES})")
    skip = options.skip_prim_id if skip_prim_id is None else skip_prim_id
    if isinstance(skip, int):
        skip = None if skip == INVALID_PRIM_ID else torch.full(
            (n,), skip, dtype=torch.int64, device=dev)
    else:
        skip = torch.as_tensor(skip, device=dev).reshape(-1).long()
        if skip.shape[0] != n:
            raise ValueError("skip_prim_id must hold one id per ray")
    lo, hi = options.prim_ids_range
    prim_range = None if (lo, hi) == (0, PRIM_RANGE_MAX) else (int(lo), int(hi))
    packet = int(sub) * LANES
    roots = None
    if packet_roots is not None:
        roots = torch.as_tensor(packet_roots, device=dev).reshape(-1)
        if roots.dtype.is_floating_point or roots.dtype == torch.bool:
            raise ValueError("packet_roots must be integer node rows")
        if roots.shape[0] != -(-n // packet):
            raise ValueError(
                f"packet_roots holds {roots.shape[0]} roots; {n} rays in "
                f"packets of sub * 128 = {packet} need {-(-n // packet)}")
    flags = None

    if dev.type == "cpu":
        start = None
        if roots is not None:
            roots = roots.long()
            if roots.numel() and not bool(
                    ((roots >= 0) & (roots < nodes.shape[0])).all()):
                raise ValueError("packet_roots holds a row outside the "
                                 "node table")
            start = roots[torch.arange(n) // packet]
        out = _traverse_reference(
            nodes, leafs, scene.width, org, dir, min_t, max_t, skip,
            prim_range, options.cull_back_face, exact_edge, occlusion,
            slots, woop, start=start, debug_counts=debug_counts,
            flag_zero_edges=_flag_zero_edges, sphere=sphere, curve=curve)
        t, u, v, pid = out[:4]
        if _flag_zero_edges:
            flags = out[4]
    elif dev.type == "cuda":
        for name, tab in (("nodes", nodes), ("leafs", leafs)):
            if tab.data_ptr() % 16:
                raise ValueError(f"scene.{name} must be 16-byte aligned")
        # the kernel compares int32 ids; 0xFFFFFFFF wraps to -1 = no skip
        skip32 = None if skip is None else skip.to(torch.int32)
        if roots is not None:
            roots = roots.to(torch.int32).contiguous()
            # checked on the stream, as the overflow word below
            torch._assert_async(
                ((roots >= 0) & (roots < nodes.shape[0])).all(),
                "packet_roots holds a row outside the node table")
        t = torch.empty(n, dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        pid = torch.empty(n, dtype=PRIM_ID_DTYPE, device=dev)
        if _flag_zero_edges:
            flags = torch.empty(n, dtype=torch.int32, device=dev)
        # the claim counter and the overflow word, zeroed on the stream
        scratch = torch.zeros(2, dtype=torch.int64, device=dev)
        occ = k1_occupancy(scene.width, woop, debug_counts,
                           _flag_zero_edges, roots is not None, dev,
                           interleave, kind)
        plan = launch_plan(n, occ["blocks_per_sm"], occ["sms"], interleave,
                           occlusion)
        _ext.launch(
            "packet_traverse", "nrt_packet_traverse", nodes, leafs, org, dir,
            min_t, max_t, skip32, roots, t, u, v, pid, flags, scratch, n,
            packet, scene.width, slots, int(occlusion),
            int(options.cull_back_face), int(exact_edge),
            int(prim_range is not None), prim_range[0] if prim_range else 0,
            prim_range[1] if prim_range else 0, _leaf(woop, kind),
            int(debug_counts), int(_flag_zero_edges), int(interleave),
            plan.grid, plan.claim // K1_CLAIM, device=dev,
            count=_launch_key(woop, roots is not None, debug_counts,
                              _flag_zero_edges, interleave, sphere, curve))
        trace.count("k1.rays", n)
        _check_overflow(scratch[1], slots)
    else:
        raise ValueError(f"unsupported device {dev}")
    hits = Hits(t.view(bs), u.view(bs), v.view(bs), pid.view(bs))
    if _flag_zero_edges:
        return hits, flags.view(bs)
    return hits


def _launch_key(woop, roots, counts, flags, interleave,
                sphere=False, curve=False) -> str:
    """The launch counter of one launch."""
    if interleave > 1:
        return f"packet_traverse[interleave={interleave}]"
    if counts:
        return "packet_traverse[counts]"
    if flags:
        return "packet_traverse[flags]"
    if roots:
        return "packet_traverse[roots]"
    if sphere:
        return "packet_traverse[sphere]"
    if curve:
        return "packet_traverse[curve]"
    return "packet_traverse_woop" if woop else "packet_traverse"


def _woop_test(rows, o, d, min_t, t_cur, cull_back_face):
    """Woop unit-triangle test of (m, 9) triangles of ``leafs_woop``
    rows against m rays, the operations of pallas_packet.py:287-330 in
    their order (``M (o - p0)``, then ``t = -o'z / d'z``). Hits farther
    than ``t_cur`` reject, an equal distance is accepted. Returns
    ``(valid, tt, u, v, prim_ids)``."""
    m = rows.shape[0]
    tri = rows[:, :108].view(m, 9, 12)
    ox, oy, oz = (o[:, a, None] for a in range(3))
    dx, dy, dz = (d[:, a, None] for a in range(3))
    rx = ox - tri[..., 9]
    ry = oy - tri[..., 10]
    rz = oz - tri[..., 11]

    def row_dot(k, x, y, z):
        return (tri[..., 3 * k] * x + tri[..., 3 * k + 1] * y
                + tri[..., 3 * k + 2] * z)

    opz = row_dot(2, rx, ry, rz)
    dpz = row_dot(2, dx, dy, dz)
    # a true division: +-inf for a ray parallel to the plane, and the
    # inf or NaN tt that follows fails every test below
    rcp = torch.ones_like(dpz) / dpz
    tt = -opz * rcp
    uu = row_dot(0, rx, ry, rz) + tt * row_dot(0, dx, dy, dz)
    vv = row_dot(1, rx, ry, rz) + tt * row_dot(1, dx, dy, dz)
    valid = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt <= t_cur[:, None]) & (tt >= min_t[:, None]))
    if cull_back_face:
        valid &= dpz < 0.0
    return valid, tt, uu, vv, rows[:, 108:117].long()


def _sphere_test(rows, o, d, min_t, t_cur):
    """Sphere test of the (m, 10) spheres of sphere leaf rows against m
    rays (``ops.sphere.sphere_hit``, the kernel's ``hit_sphere``).
    Returns ``(valid, tt, prim_ids)``."""
    m = rows.shape[0]
    sp = rows[:, :4 * SPHERE_MAX_LEAF].view(m, SPHERE_MAX_LEAF, 4)
    valid, tt = sphere_hit(o[:, None, :], d[:, None, :], sp[..., :3],
                           sp[..., 3], min_t[:, None], t_cur[:, None])
    return valid, tt, rows[:, 108:108 + SPHERE_MAX_LEAF].long()


def _curve_test(rows, rot, trans, min_t, t_cur):
    """Curve test of the (m, 6) curves of curve leaf rows against m rays
    of z-align frames ``rot`` (m, 3, 3), ``trans`` (m, 3)
    (``ops.curve.curve_hit`` with 4 spans, the kernel's ``hit_curve``).
    Returns ``(valid, tt, u, v, prim_ids)``."""
    m = rows.shape[0]
    q = rows[:, :16 * CURVE_MAX_LEAF].view(m, CURVE_MAX_LEAF, 4, 4)
    cps = _project(q[..., :3], rot[:, None]) + trans[:, None, None, :]
    valid, tt, uu, vv = curve_hit(cps, q[..., 0, 3], q[..., 3, 3],
                                  min_t[:, None], t_cur[:, None])
    return valid, tt, uu, vv, rows[:, 108:108 + CURVE_MAX_LEAF].long()


def _traverse_reference(nodes, leafs, width, org, dir, min_t, max_t, skip,
                        prim_range, cull_back_face, exact_edge_fallback,
                        occlusion, slots, woop=False, stats=None, start=None,
                        debug_counts=False, flag_zero_edges=False,
                        sphere=False, curve=False):
    """Plain torch version of the kernel: a batched per-ray stack
    traversal over the same tables, in the same child order, with the
    same arithmetic (``ops/triangle.py``, ``_woop_test`` when ``woop``,
    ``_sphere_test`` over sphere leaf rows when ``sphere``, ``_curve_test``
    over curve leaf rows when ``curve``). Every loop step pops one entry
    for every live ray: node entries run ``width`` slab tests and push
    their hit children far-first; leaf entries test their <= 10 (woop:
    <= 9) triangles, <= 10 spheres or <= 6 curves.
    ``start`` is each ray's first node row (default row 0).

    Returns flat ``(t, u, v, prim_id)``; with ``debug_counts`` u and v
    are each ray's node pops and leaf pops, and ``flag_zero_edges`` adds
    a fifth int32 tensor of zero-edge flags, set over the triangles the
    kernel tests (in any-hit mode, those up to the first accepted one).
    ``stats``, a dict, gains the work this batch needed: ``"nodes"`` and
    ``"leaves"`` popped and triangles tested (``"tris"``), added to what
    it holds, the distinct node and leaf rows this call read
    (``"node_rows"``, ``"leaf_rows"``), and the deepest stack any ray
    reached (``"max_sp"``: entries after a node's pushes, the most it
    held, kept as the largest over the calls it saw)."""
    dev = org.device
    n = org.shape[0]
    inf = float("inf")
    ok = _well_formed(org, dir)
    o = torch.where(ok[:, None], org, 0.0)
    d = torch.where(ok[:, None], dir,
                    torch.tensor([1.0, 0.0, 0.0], device=dev))
    mint = torch.where(ok, min_t, inf)
    t_best = torch.where(ok, max_t, inf)
    inv = safe_inverse(d)
    neg = d < 0
    coeffs = ray_coeffs(d)
    if curve:  # each ray's z-align frame, once (the kernel's curve_ray)
        rot, trans = _z_align(o, d)

    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    pid_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    # column ``slots`` is a write sink for children that are not pushed
    stack = torch.zeros((n, slots + 1), dtype=torch.int64, device=dev)
    if start is not None:
        stack[:, 0] = start
    n_nodes = torch.zeros(n, dtype=torch.int32, device=dev)
    n_leaves = torch.zeros(n, dtype=torch.int32, device=dev)
    zflag = torch.zeros(n, dtype=torch.int32, device=dev)
    if stats is not None:
        seen_n = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
        seen_l = torch.zeros(leafs.shape[0], dtype=torch.bool, device=dev)
    # the start row at slot 0; a ray whose interval is empty or NaN
    # (!(min_t <= max_t)) fails every slab test and retires at once
    sp = (mint <= t_best).long()
    if stats is not None and n:
        stats["max_sp"] = max(stats.get("max_sp", 0), int(sp.max()))
    ar_w = torch.arange(width, device=dev)
    n_slots = CURVE_MAX_LEAF if curve else (9 if woop else 10)
    ar_l = torch.arange(n_slots, device=dev)
    zeros_l = torch.zeros(n_slots, device=dev)
    if width == 16:
        meta_lane, count_lane = 96, 112
    else:
        meta_lane, count_lane = 64, 72

    while True:
        live = sp > 0
        if occlusion:
            live &= ~found
        idx = live.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        e = stack[idx, sp[idx]]

        # ---- node entries: slab-test every child, push hits far-first
        ni = idx[e >= 0]
        n_nodes[ni] += 1
        n_leaves[idx[e < 0]] += 1
        if stats is not None:
            stats["nodes"] = stats.get("nodes", 0) + int(ni.numel())
            stats["leaves"] = stats.get("leaves", 0) + int(
                idx.numel() - ni.numel())
            stats["tris"] = stats.get("tris", 0) + int(
                ((-1 - e[e < 0]) & 15).sum())
            seen_n[e[e >= 0]] = True
            seen_l[(-1 - e[e < 0]) >> 4] = True
        if ni.numel():
            rows = nodes.index_select(0, e[e >= 0])
            m = ni.shape[0]
            if width == 16:
                box = rows[:, :96].view(m, 16, 6)
                v112 = rows[:, 112]
                axis = torch.where(v112 >= 32, 2, torch.where(v112 >= 16, 1, 0))
            else:
                box = rows[:, :64].view(m, 8, 8)[:, :, :6]
                a80 = rows[:, 80]
                axis = torch.where(a80 == 0, 0, torch.where(a80 == 1, 1, 2))
            nn = neg[ni][:, None, :]
            lo = torch.where(nn, box[..., 3:6], box[..., 0:3])
            hi = torch.where(nn, box[..., 0:3], box[..., 3:6])
            on = o[ni][:, None, :]
            iv = inv[ni][:, None, :]
            t0 = (lo - on) * iv
            t1 = (hi - on) * iv * MAX_MULT
            tmin = mint[ni][:, None].expand(m, width)
            tmax = t_best[ni][:, None].expand(m, width)
            for a in range(3):  # NaN-skipping where-folds, x then y then z
                tmin = torch.where(t0[..., a] > tmin, t0[..., a], tmin)
                tmax = torch.where(t1[..., a] < tmax, t1[..., a], tmax)
            hit = tmin <= tmax
            neg_axis = neg[ni].gather(1, axis[:, None])[:, 0]
            order = torch.where(neg_axis[:, None], ar_w, width - 1 - ar_w)
            push = hit.gather(1, order)
            meta = rows[:, meta_lane:meta_lane + width].gather(1, order).long()
            cnt = rows[:, count_lane:count_lane + width].gather(1, order).long() & 15
            entry = torch.where(meta >= 0, meta, -1 - (((-meta - 1) << 4) | cnt))
            sp_n = sp[ni]
            pos = sp_n[:, None] + push.long().cumsum(1) - 1
            new_sp = sp_n + push.sum(1)
            if bool((new_sp > slots).any()):
                raise RuntimeError(
                    f"traversal stack overflow ({slots} slots): scene.depth "
                    "does not describe the tables")
            pos = torch.where(push, pos, slots)
            stack[ni[:, None].expand(m, width), pos] = entry
            sp[ni] = new_sp
            if stats is not None:
                stats["max_sp"] = max(stats.get("max_sp", 0),
                                      int(new_sp.max()))

        # ---- leaf entries: test the row's triangles in slot order
        li = idx[e < 0]
        if li.numel():
            packed = -1 - e[e < 0]
            rows = leafs.index_select(0, packed >> 4)
            cnt = packed & 15
            m = li.shape[0]
            tc = t_best[li]
            if sphere:
                valid, tt, pids = _sphere_test(rows, o[li], d[li], mint[li],
                                               tc)
                uu = vv = zeros_l.expand(m, n_slots)
            elif curve:
                valid, tt, uu, vv, pids = _curve_test(rows, rot[li],
                                                      trans[li], mint[li], tc)
            elif woop:
                valid, tt, uu, vv, pids = _woop_test(
                    rows, o[li], d[li], mint[li], tc, cull_back_face)
            else:
                tri = rows[:, :90].view(m, 10, 9)
                pids = rows[:, 90:100].long()
                co = RayCoeffs(*(c[li][:, None] for c in coeffs))
                valid, tt, uu, vv, zmask = intersect_triangles(
                    co, o[li][:, None, :], mint[li][:, None], tc[:, None],
                    tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
                    cull_back_face=cull_back_face,
                    exact_edge_fallback=exact_edge_fallback,
                    zero_edges=True)
            in_row = ar_l < cnt[:, None]
            valid &= in_row
            if skip is not None:
                valid &= pids != skip[li][:, None]
            if prim_range is not None:
                valid &= (pids >= prim_range[0]) & (pids < prim_range[1])
            # sequential tt <= t replacement == the LAST slot holding the
            # minimum t (a curve's t < t replacement: the FIRST); any-hit
            # stops at the FIRST accepted slot
            t_m = torch.where(valid, tt, inf)
            t_min = t_m.amin(1)
            if occlusion or curve:
                first = valid if occlusion else valid & (t_m == t_min[:, None])
                sel = torch.where(first, ar_l, n_slots).amin(1)
            else:
                sel = torch.where(valid & (t_m == t_min[:, None]), ar_l,
                                  -1).amax(1)
            if flag_zero_edges and not woop and not sphere and not curve:
                # the kernel's any-hit loop stops after the accepted slot
                tested = in_row & (ar_l <= sel[:, None]) if occlusion else in_row
                zflag[li] |= (zmask & tested).any(1).int()
            any_v = valid.any(1)
            take = sel.clamp(0, n_slots - 1)[:, None]
            t_best[li] = torch.where(any_v, tt.gather(1, take)[:, 0], tc)
            u_best[li] = torch.where(any_v, uu.gather(1, take)[:, 0], u_best[li])
            v_best[li] = torch.where(any_v, vv.gather(1, take)[:, 0], v_best[li])
            pid_best[li] = torch.where(any_v, pids.gather(1, take)[:, 0],
                                       pid_best[li])
            found[li] |= any_v

    if stats is not None:
        stats["node_rows"] = int(seen_n.sum())
        stats["leaf_rows"] = int(seen_l.sum())
    hit = found if occlusion else t_best < max_t
    t = torch.where(hit, t_best, max_t) if occlusion else t_best
    zero = torch.zeros((), device=dev)
    if debug_counts:
        u, v = n_nodes.float(), n_leaves.float()
    else:
        u = torch.where(hit, u_best, zero)
        v = torch.where(hit, v_best, zero)
    out = (t, u, v, torch.where(hit, pid_best, INVALID_PRIM_ID))
    if flag_zero_edges:
        return out + (zflag,)
    return out


def _flat_rays(rays: Rays) -> Rays:
    bs = rays.batch_shape
    return Rays(*(x.reshape((-1,) + x.shape[len(bs):]) for x in rays))


def _take_skip(skip_prim_id, idx):
    """A per-ray ``skip_prim_id`` restricted to rays ``idx`` (an int or
    None stays as it is)."""
    if skip_prim_id is None or isinstance(skip_prim_id, int):
        return skip_prim_id
    return torch.as_tensor(skip_prim_id, device=idx.device).reshape(-1)[idx]


def _merge(hits: Hits, idx, fixed: Hits) -> Hits:
    """``hits`` with the flat rays ``idx`` replaced by ``fixed`` (equal
    indices carry equal records)."""
    def put(full, part):
        flat = full.reshape(-1).clone()
        flat[idx] = part.reshape(-1)
        return flat.view(full.shape)

    return Hits(*(put(a, b) for a, b in zip(hits, fixed)))


def traverse_bvh8_exact(scene: BVH8Scene, rays: Rays,
                        options: BVHTraceOptions = BVHTraceOptions(),
                        skip_prim_id=None, sub: int = DEF_SUB) -> Hits:
    """Two-pass exact-edge traversal (pallas_packet.py:2382-2452): the
    records of ``exact_edge_fallback=True``.

    Pass 1 runs with the exact-edge recompute off and flags every ray
    that tested a triangle with a zero edge function (the K1 flags
    kernel); only those rays' records can differ under the recompute.
    The flags reduce to one per packet of ``sub * 128`` rays, read on
    the host (one sync). Flagged packets are retraced with exact edges
    and their records replace pass 1's; when more than ``n_packets //
    8`` packets are flagged (a degenerate, axis-aligned scene), the
    whole batch is traced exact instead. Each ray walks alone in this
    kernel, so the records equal the single-pass exact ones bit for
    bit. The recompute costs the kernel next to nothing, so the single
    pass, ``traverse_bvh8``, is the faster way to them (PERF.md)."""
    opt_fast = dataclasses.replace(options, exact_edge_fallback=False)
    hits, zflag = traverse_bvh8(scene, rays, opt_fast, skip_prim_id,
                                _flag_zero_edges=True)
    packet = sub * LANES
    zf = zflag.reshape(-1)
    n = zf.shape[0]
    n_packets = -(-n // packet)
    zf = torch.nn.functional.pad(zf, (0, n_packets * packet - n))
    pidx = zf.view(n_packets, packet).amax(1).nonzero().squeeze(1)
    if pidx.numel() == 0:
        return hits
    opt_exact = dataclasses.replace(options, exact_edge_fallback=True)
    if pidx.numel() > max(1, n_packets // 8):
        return traverse_bvh8(scene, rays, opt_exact, skip_prim_id)
    idx = (pidx[:, None] * packet
           + torch.arange(packet, device=pidx.device)).reshape(-1)
    idx = idx.clamp(max=n - 1)  # the tail packet clamps into range
    sub_rays = Rays(*(x[idx] for x in _flat_rays(rays)))
    fixed = traverse_bvh8(scene, sub_rays, opt_exact,
                          _take_skip(skip_prim_id, idx))
    return _merge(hits, idx, fixed)


def traverse_bvh8_exact_fused(scene: BVH8Scene, rays: Rays,
                              options: BVHTraceOptions = BVHTraceOptions(),
                              skip_prim_id=None, specialize=None,
                              fix_rows: int = 2048):
    """Exact-edge two-pass traversal without a host sync
    (pallas_packet.py:2455-2545). Returns ``(hits, overflow)``.

    Pass 1 is the flags kernel with the exact recompute off. The flags
    reduce to one per row of 128 rays; up to ``fix_rows`` flagged rows,
    in row order, are retraced with exact edges and replace pass 1's
    records. ``overflow``, a device bool, is True when more rows were
    flagged: those beyond the capacity keep pass 1's records. Without
    overflow the records equal the single-pass exact ones bit for bit.
    The JAX function's ``sub`` and ``fix_sub`` group rays into packets
    of its TPU kernel; this kernel walks one ray a thread, so they are
    not taken. ``specialize`` is validated as ``traverse_bvh8`` does. As
    for ``traverse_bvh8_exact``, the single pass is faster (PERF.md)."""
    if not options.exact_edge_fallback:
        raise ValueError("exact_fused requires exact_edge_fallback=True")
    opt_fast = dataclasses.replace(options, exact_edge_fallback=False)
    hits, zflag = traverse_bvh8(scene, rays, opt_fast, skip_prim_id,
                                specialize=specialize, _flag_zero_edges=True)
    zf = zflag.reshape(-1)
    n = zf.shape[0]
    n_rows = -(-n // LANES)
    zf = torch.nn.functional.pad(zf, (0, n_rows * LANES - n))
    row_flag = zf.view(n_rows, LANES).amax(1) > 0
    if fix_rows < 1:
        raise ValueError(f"fix_rows must be positive: {fix_rows}")
    overflow = row_flag.sum() > fix_rows
    # flagged rows first, in row order (a stable sort on "not flagged"),
    # then unflagged ones as filler, whose records are kept
    idx_rows = torch.argsort((~row_flag).to(torch.int32),
                             stable=True)[:fix_rows]
    valid = row_flag[idx_rows].repeat_interleave(LANES)
    idx = (idx_rows[:, None] * LANES
           + torch.arange(LANES, device=idx_rows.device)).reshape(-1)
    idx = idx.clamp(max=n - 1)  # the tail row clamps into range
    sub_rays = Rays(*(x[idx] for x in _flat_rays(rays)))
    fixed = traverse_bvh8(scene, sub_rays, options,
                          _take_skip(skip_prim_id, idx), specialize=specialize)
    flat = Hits(*(x.reshape(-1) for x in hits))
    keep = Hits(*(torch.where(valid, f, a[idx]) for f, a in zip(fixed, flat)))
    return _merge(hits, idx, keep), overflow


def refit_hits_watertight(mesh: TriangleMesh, rays: Rays, hits: Hits,
                          options: BVHTraceOptions = BVHTraceOptions()
                          ) -> Hits:
    """Recompute each hit's (t, u, v) with the reference watertight test
    (nanort.h:993-1229) against the already-selected triangle: one
    triangle per ray, plain torch (an XLA pass in the JAX package,
    pallas_packet.py:2548).

    Pairs with ``intersector="woop"``: the Woop kernel picks the prim,
    this pass restores watertight records for it. Where the watertight
    re-test rejects the hit (only within an ulp of an edge), or the ray
    missed, the record is kept as it is. ``mesh`` fields may be NumPy
    arrays or tensors."""
    bs = rays.batch_shape
    dev = rays.org.device
    org = rays.org.reshape(-1, 3)
    dir = rays.dir.reshape(-1, 3)
    pid = hits.prim_id.reshape(-1)
    hit = pid != INVALID_PRIM_ID
    verts = torch.as_tensor(mesh.vertices, device=dev)
    faces = torch.as_tensor(mesh.faces, device=dev).long()
    tri9 = verts[faces].reshape(-1, 9).to(torch.float32)
    g = tri9[torch.where(hit, pid, 0)]
    valid, tt, uu, vv = intersect_triangles(
        ray_coeffs(dir), org, rays.min_t.reshape(-1),
        rays.max_t.reshape(-1), g[:, 0:3], g[:, 3:6], g[:, 6:9],
        cull_back_face=options.cull_back_face,
        exact_edge_fallback=options.exact_edge_fallback)
    valid &= hit

    def keep(new, old):
        return torch.where(valid, new, old.reshape(-1)).reshape(bs)

    return Hits(keep(tt, hits.t), keep(uu, hits.u), keep(vv, hits.v),
                hits.prim_id)


def detect_specialization(rays: Rays, sub: int | None = None) -> tuple | None:
    """Which bit-exact batch specializations a ray batch qualifies for,
    with the JAX package's semantics (pallas_packet.py:2310-2379):
    ``(kz | None, shared_origin[, uniform_sign])`` or None. ``kz`` is the
    shear axis every live ray shares, ``shared_origin`` whether every
    live ray has one origin, and ``uniform_sign`` (only when ``sub`` is
    given) whether each ``sub * 128``-ray packet shares one octant."""
    org = rays.org.reshape(-1, 3).float()
    d = rays.dir.reshape(-1, 3).float()
    ok = _well_formed(org, d)
    if not bool(ok.any()):
        return None
    first = int(ok.long().argmax())
    shared = bool(torch.where(ok[:, None], org == org[first][None, :],
                              True).all())
    ad = d.abs()
    kz = torch.where(ad[:, 1] > ad[:, 0], 1, 0)
    amax = torch.where(ad[:, 1] > ad[:, 0], ad[:, 1], ad[:, 0])
    kz = torch.where(ad[:, 2] > amax, 2, kz)
    kz_uniform = bool(torch.where(ok, kz == kz[first], True).all())
    kz_val = int(kz[first]) if kz_uniform else None
    if sub is None:
        if kz_val is None and not shared:
            return None
        return (kz_val, shared)
    packet = sub * LANES
    n = d.shape[0]
    n_pk = -(-n // packet)
    pad = n_pk * packet - n
    live = ok & (rays.max_t.reshape(-1) > rays.min_t.reshape(-1))
    live_p = torch.nn.functional.pad(live, (0, pad)).view(n_pk, packet)
    usign = True
    for a in range(3):
        negp = torch.nn.functional.pad(d[:, a] < 0, (0, pad)).view(n_pk, packet)
        any_n = (negp & live_p).any(1)
        all_n = ~(~negp & live_p).any(1)
        usign = usign and bool((any_n == all_n).all())
    if kz_val is None and not shared and not usign:
        return None
    return (kz_val, shared, usign)


def tile_image_rays(rays: Rays, tile_h: int = 32, tile_w: int = 32,
                    pad: bool = False):
    """Reorder (H, W) image rays into ``tile_h x tile_w`` pixel tiles so
    each group of neighbouring rays covers a compact frustum (a warp's 32
    rays are neighbouring pixels). Returns ``(flat_rays, untile)`` where
    ``untile`` restores the image shape of any NamedTuple of (H*W, ...)
    tensors, e.g. ``Hits``. An image whose sides are not multiples of the
    tile raises, unless ``pad``: then the tile grid is padded to whole
    tiles with rays of an empty interval (``max_t < min_t``: they retire
    before their first node), and ``untile`` drops the padding.
    ``traverse_image`` makes no such copy: K1 walks a camera's (H, W)
    batch as fast with its rays in raster order."""
    H, W = rays.org.shape[:2]
    if (H % tile_h or W % tile_w) and not pad:
        raise ValueError(f"image {H}x{W} is not a multiple of the "
                         f"{tile_h}x{tile_w} tile")
    Hp, Wp = -(-H // tile_h) * tile_h, -(-W // tile_w) * tile_w

    def fwd(x, fill):
        if (Hp, Wp) != (H, W):
            trail = (0, 0) * (x.ndim - 2)
            x = torch.nn.functional.pad(x, trail + (0, Wp - W, 0, Hp - H),
                                        value=fill)
        x = x.reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w,
                      *x.shape[2:])
        return x.transpose(1, 2).reshape(Hp * Wp, *x.shape[4:])

    def untile(tree):
        def inv(x):
            x = x.reshape(Hp // tile_h, Wp // tile_w, tile_h, tile_w,
                          *x.shape[1:])
            x = x.transpose(1, 2).reshape(Hp, Wp, *x.shape[4:])
            return x if (Hp, Wp) == (H, W) else x[:H, :W].contiguous()

        with trace.span("untile"):
            return type(tree)(*(inv(x) for x in tree))

    with trace.span("tile"):
        # padding: origin 0, direction (1, 1, 1), the interval [0, -1]
        return Rays(*(fwd(x, fill) for x, fill in
                      zip(rays, (0.0, 1.0, 0.0, -1.0)))), untile


def traverse_image(scene: BVH8Scene, rays: Rays,
                   options: BVHTraceOptions = BVHTraceOptions(),
                   specialize: tuple | None = None) -> Hits:
    """A camera's batch through K1: an (H, W) batch in one launch over
    its rays as they lie, in raster order (a warp's claim of 32 rays is
    32 neighbouring pixels of a row), with no tiled copy of the rays or
    the records; any other shape through
    ``ray_sort.traverse_bvh8_sorted``. Records in the rays' shape."""
    bs = rays.batch_shape
    if len(bs) == 2:
        return traverse_bvh8(scene, Rays(*(x.contiguous() for x in rays)),
                             options, specialize=specialize)
    from .ray_sort import traverse_bvh8_sorted

    return traverse_bvh8_sorted(scene, rays, options)
