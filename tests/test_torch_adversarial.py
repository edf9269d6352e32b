"""The JAX suite's robustness scenes on the port, and the public functions
that came with them, against hfvo_tpu on the same seeded inputs.

(a) Scenes: `make_quad_texture`, `make_adversarial_room` and the
    low-texture room's textures equal to the JAX package's, array for array.
(b) `render` with slanted quads and spheres at 160x120 (tum3's camera
    scaled), on the slanted room and the low-texture slanted room. A pixel
    whose depths part by more than 1 mm hit different surfaces: at most
    0.1 % of pixels (a silhouette). On walls and quads (told apart by the
    port's own renders without quads and spheres) depth agrees within
    1e-5 m everywhere and gray within 1e-2 on 99.9 % of the pixels, 0.05
    everywhere: a stripe edge turns 210 gray levels within one texel, so an
    ulp of the texel coordinate (~1.5e-5 at 255 texels) is 3e-3 gray, and
    the two packages round their dot products in different orders. On
    spheres depth within 1e-5 m + 2 eps z / sqrt(disc / B^2), float32's
    rounding of the hit's square root, amplified where the discriminant
    vanishes at the silhouette: between the packages and from each to a
    float64 render of the same formulas; gray within 1e-2 of the float64
    shade at each package's own depth.
(c) `ic_angles` (2e-4 rad, tests/test_torch_orb.py's reason),
    `brief_descriptors` (exact, on the JAX package's angles),
    `hamming_pairs` (exact) and `build_global_ba_problem` with `max_edges`,
    `max_line_edges` (exact, both packages reading one map; the JAX
    package's `pad=False` tables, `pad` is not ported).
(d) tum1 and ICL front ends at 160x120: `extract_frame` with the tum1
    undistortion on a frame rendered through the radtan model, and with
    ICL's negative fy on an ICL frame; level-0 keypoints exactly, their
    undistorted coordinates and u_r within 1e-3 px. On the ICL frame also
    the sign-sensitive geometry: `compute_normals` (normals within 1e-6),
    `segment_planes` (planes within 1e-4) and `fit_lines_3d` (endpoints
    within 1e-5 m, up to the X0/X1 order of a constant-depth line,
    tests/test_torch_lines3d.py).
(e) The slice as a whole: the port's Tracker against the JAX Tracker on
    the slanted room under `tum3_config()` (local BA on, loop closing off,
    as tests/test_adversarial.py runs it) over frames 0-3 at 640x480: poses
    within 2 mm and 0.1 deg, point and line matches at least 75 % of
    JAX's. The JAX run is shared across xdist workers
    (torch_helpers.shared_result); its programs are those of
    tests/test_adversarial.py, which JAX's persistent cache shares.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfvo_tpu import config as jconfig
from hfvo_tpu.ops import hamming as jham
from hfvo_tpu.ops import lines as jlines
from hfvo_tpu.ops import lines3d as jl3
from hfvo_tpu.ops import orb as jorb
from hfvo_tpu.ops import planes as jplanes
from hfvo_tpu.solve import global_ba as jgba
from hfvo_tpu.testing import synthetic as jsyn
from hfvo_tpu.tracking import frontend as jfront
from hfvo_tpu.tracking.tracker import Tracker as JaxTracker
from hfvo_tpu_torch import config as tconfig
from hfvo_tpu_torch.ops import hamming as tham
from hfvo_tpu_torch.ops import lines as tlines
from hfvo_tpu_torch.ops import lines3d as tl3
from hfvo_tpu_torch.ops import orb as torb
from hfvo_tpu_torch.ops import planes as tplanes
from hfvo_tpu_torch.solve import global_ba as tgba
from hfvo_tpu_torch.testing import loop_map
from hfvo_tpu_torch.testing.adversarial import SCENES
from hfvo_tpu_torch.testing import synthetic as tsyn
from hfvo_tpu_torch.tracking import frontend as tfront
from hfvo_tpu_torch.tracking.tracker import Tracker
from hfvo_tpu_torch.vomap.map import VOMap
from torch_helpers import shared_result, small_intrinsics, t

def _scaled(cam):
    """A preset's camera scaled to 160x120 (its distortion unchanged: it
    acts on normalized coordinates)."""
    s = 160 / cam.width
    return cam._replace(fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s, cy=cam.cy * s, bf=cam.bf * s,
                        width=160, height=120)


# (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4, 9, 10])
def test_make_quad_texture_equal(seed):
    np.testing.assert_array_equal(tsyn.make_quad_texture(seed), jsyn.make_quad_texture(seed))


def test_low_texture_room_textures_equal():
    """The low-texture walls are a 4 -> 512 cubic upsampling, where XLA's
    fused multiply-adds in the resize weights once parted the two packages
    by an ulp (ops/image.py::_keys_cubic)."""
    for seed in (0, 9):
        np.testing.assert_array_equal(tsyn.make_room_textures(seed, low_texture=True),
                                      jsyn.make_room_textures(seed, low_texture=True))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_make_adversarial_room_equal(name):
    want, got = jsyn.make_adversarial_room(**SCENES[name]), tsyn.make_adversarial_room(**SCENES[name])
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.quad_c.shape == (2, 3) and got.sphere_r.shape == (SCENES[name]["n_spheres"],)


# (b) ---------------------------------------------------------------------


def _spheres_f64(scene, intr, T_wc, z=None):
    """The second witness for the sphere pixels, in float64 from the
    float32 inputs (hfvo_tpu/testing/synthetic.py:299-329's formulas): the
    nearest sphere hit's depth, its shade (at depth `z` on the same ray
    instead, if given) and its quadratic's conditioning disc / B^2."""
    h, w = intr.height, intr.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d_c = np.stack([(xx - np.float32(intr.cx)) / np.float32(intr.fx),
                    (yy - np.float32(intr.cy)) / np.float32(intr.fy), np.ones_like(xx)], -1)
    d_w = np.einsum("ij,hwj->hwi", T_wc[:3, :3].astype(np.float32).astype(np.float64), d_c.astype(np.float64))
    o = T_wc[:3, 3].astype(np.float32).astype(np.float64)
    lam_best, val, cond = np.full((h, w), np.inf), np.zeros((h, w)), np.zeros((h, w))
    for c, r in zip(scene.sphere_c.numpy().astype(np.float64), scene.sphere_r.numpy().astype(np.float64)):
        oc = o - c
        A, B, C = (d_w * d_w).sum(-1), 2.0 * d_w @ oc, oc @ oc - r * r
        disc = B * B - 4.0 * A * C
        lam = (-B - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * A)
        nrm = (o + (lam if z is None else z)[..., None] * d_w - c) / r
        lat, lon = np.arcsin(np.clip(nrm[..., 1], -1, 1)), np.arctan2(nrm[..., 2], nrm[..., 0])
        shade = np.clip(nrm @ np.array([0.4, -0.6, -0.7]), 0.2, 1.0)
        v = np.clip((120.0 + 70.0 * np.sin(lat * 9.0 + np.sin(lon * 3.0))) * shade + 40.0, 0.0, 255.0)
        closer = (disc > 0) & (lam > 0.05) & (lam < lam_best)
        lam_best, val, cond = (np.where(closer, x, y) for x, y in ((lam, lam_best), (v, val), (disc / (B * B), cond)))
    return lam_best, val, cond


@pytest.mark.parametrize("name,frame", [("slanted", 4), ("slanted", 20), ("low_texture_slanted", 16)])
def test_render_quads_and_spheres_match_jax(name, frame):
    intr = small_intrinsics()
    T_wc = tsyn.orbit_trajectory(25)[frame]
    jg, jd = (np.asarray(a) for a in jsyn.render_jit(jsyn.make_adversarial_room(**SCENES[name]), intr,
                                                      jnp.asarray(T_wc)))
    scene = tsyn.make_adversarial_room(**SCENES[name])
    tg, td = (a.numpy() for a in tsyn.render(scene, intr, torch.from_numpy(T_wc)))
    # The port's surface ids: 0 walls, 1 quads, 2 spheres.
    none = torch.zeros((0, 3))
    walls = tsyn.render(scene._replace(quad_c=none, sphere_c=none, sphere_r=none[:, 0]), intr,
                        torch.from_numpy(T_wc))[1].numpy()
    no_quads = tsyn.render(scene._replace(quad_c=none), intr, torch.from_numpy(T_wc))[1].numpy()
    sid = np.where(td == walls, 0, np.where(td == no_quads, 2, 1))
    assert (sid == 1).mean() > 0.05 and (sid == 2).mean() > 0.02  # both kinds in view
    dz, dg = np.abs(td - jd), np.abs(tg - jg)
    same = dz <= 1e-3
    assert (~same).mean() <= 1e-3, (~same).sum()
    flat = same & (sid < 2)
    assert dz[flat].max() <= 1e-5
    assert (dg[flat] <= 1e-2).mean() >= 0.999 and dg[flat].max() <= 0.05, dg[flat].max()
    # Spheres. The hit depth is (-B - sqrt(disc)) / 2A, and float32 rounds
    # disc by ~eps B^2, which moves the depth by a relative ~eps /
    # sqrt(disc / B^2): large only where the discriminant vanishes, at the
    # silhouette. So on every sphere pixel the two packages' depths, and
    # each against the float64 render, agree within 1e-5 m + 2 eps z /
    # sqrt(disc / B^2): the walls' 1e-5 m where the quadratic is well
    # conditioned (seen over 50 frames of both scenes: at most 0.94 of
    # 1e-5 m + eps z / sqrt(disc / B^2)). Gray is the shade of the hit:
    # each package's within 1e-2 of the float64 shade at its own depth
    # (seen: 6.2e-4).
    ball = sid == 2
    z64, _, cond = _spheres_f64(scene, intr, T_wc)
    tol = 1e-5 + 2.0 * np.finfo(np.float32).eps * z64[ball] / np.sqrt(cond[ball])
    assert np.isfinite(tol).all()
    for z, g in ((td, tg), (jd, jg)):
        assert (np.abs(z - z64)[ball] <= tol).all()
        g64 = _spheres_f64(scene, intr, T_wc, z.astype(np.float64))[1]
        assert np.abs(g - g64)[ball].max() <= 1e-2
    assert (dz[ball] <= tol).all(), (dz[ball] / tol).max()


def test_render_without_quads_or_spheres_is_the_room():
    """A scene with empty quad and sphere tables renders the walls only,
    bit for bit as the six-face room."""
    intr = small_intrinsics()
    T_wc = torch.from_numpy(tsyn.orbit_trajectory(3)[2])
    room = tsyn.render(tsyn.make_room(3), intr, T_wc)
    none = tsyn.render(tsyn.make_adversarial_room(seed=3, n_slanted=0, n_spheres=0), intr, T_wc)
    for a, b in zip(room, none):
        assert torch.equal(a, b)


# (c) ---------------------------------------------------------------------


def _keypoints(g, n=80, seed=2):
    """Integer (y, x) keypoints, some near the border (patches clamp)."""
    rs = np.random.default_rng(seed)
    yx = np.stack([rs.integers(0, g.shape[0], n), rs.integers(0, g.shape[1], n)], 1).astype(np.int32)
    yx[:4] = [[0, 0], [g.shape[0] - 1, g.shape[1] - 1], [3, 80], [60, 2]]
    return yx


def test_ic_angles_and_brief_descriptors_match_jax():
    g = tsyn.render(tsyn.make_adversarial_room(**SCENES["slanted"]), small_intrinsics(),
                    torch.from_numpy(tsyn.orbit_trajectory(1)[0]))[0].numpy()
    yx = _keypoints(g)
    ang_j = np.asarray(jorb.ic_angles(jnp.asarray(g), jnp.asarray(yx)))
    np.testing.assert_allclose(torb.ic_angles(t(g), t(yx)).numpy(), ang_j, atol=2e-4)
    want = np.asarray(jorb.brief_descriptors(jnp.asarray(g), jnp.asarray(yx), jnp.asarray(ang_j)))
    got = torb.brief_descriptors(t(g), t(yx), t(ang_j)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    # Batched: two images at once give each image's rows.
    both = torb.brief_descriptors(t(np.stack([g, g[::-1].copy()])), t(np.stack([yx, yx])), t(np.stack([ang_j] * 2)))
    np.testing.assert_array_equal(both[0].numpy(), got)


def test_hamming_pairs_exact():
    rs = np.random.default_rng(0)
    a = rs.integers(0, 2**32, (70, 8), dtype=np.uint32)
    b = rs.integers(0, 2**32, (70, 8), dtype=np.uint32)
    b[:5] = a[:5]
    b[5] = ~a[5]
    want = np.asarray(jham.hamming_pairs(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_pairs(t(a.astype(np.int64)), t(b.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:5] == 0).all() and want[5] == 256


@pytest.fixture(scope="module")
def loop_vomap():
    """The synthetic loop map (20 keyframes with points and lines) in the
    port's tables; the JAX package's `build_global_ba_problem` reads the
    same numpy tables."""
    cfg = tconfig.tum3_config()
    vm = VOMap(cfg)
    from hfvo_tpu_torch.bow.database import KeyFrameDatabase

    loop_map.build_loop_map(vm, KeyFrameDatabase(cfg.cap.keyframes), cfg)
    return vm


@pytest.mark.parametrize("kw", [
    dict(), dict(max_edges=500), dict(max_edges=10**6), dict(max_line_edges=40),
    dict(max_edges=300, max_line_edges=16), dict(max_edges=100, max_line_edges=0),
])
def test_build_global_ba_problem_options_match_jax(loop_vomap, kw):
    """The port builds the JAX package's `pad=False` tables (ROADMAP.md,
    "The public surface": `pad` is not ported)."""
    want = jgba.build_global_ba_problem(loop_vomap, gauge_kf=int(np.nonzero(loop_vomap.keyframes.valid)[0][3]),
                                        pad=False, **kw)
    got = tgba.build_global_ba_problem(loop_vomap, gauge_kf=int(np.nonzero(loop_vomap.keyframes.valid)[0][3]),
                                       device="cpu", **kw)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    for f in tgba.GlobalBAProblem._fields:
        np.testing.assert_array_equal(getattr(got[0], f).numpy(), np.asarray(getattr(want[0], f)), err_msg=f)
    E = int(np.asarray(want[0].e_valid).sum())
    if "max_edges" in kw:
        assert E == min(kw["max_edges"], int(np.asarray(want[0].e_valid).shape[0]))
    if "max_line_edges" in kw:
        assert int(np.asarray(want[0].le_valid).sum()) == kw["max_line_edges"]


# (d) ---------------------------------------------------------------------


def _front_pair(preset, distort):
    """(JAX features, port features, gray, depth, the two configs) of frame 2
    of the orbit rendered through the preset's camera at 160x120."""
    jc = getattr(jconfig, preset)()
    tc = getattr(tconfig, preset)()
    cam = _scaled(tc.camera)
    orb = dict(n_features=300, n_levels=3)
    jc = jc.replace(camera=cam, orb=dataclasses.replace(jc.orb, **orb),
                    cap=dataclasses.replace(jc.cap, keypoints=320))
    tc = tc.replace(camera=cam, orb=dataclasses.replace(tc.orb, **orb),
                    cap=dataclasses.replace(tc.cap, keypoints=320))
    g, d = tsyn.render(tsyn.make_room(4), cam, torch.from_numpy(tsyn.orbit_trajectory(3)[2]), distort)
    g, d = g.numpy(), d.numpy()
    jf = jfront.extract_frame(jnp.asarray(g), jnp.asarray(d), jc)
    tf = tfront.extract_frame(t(g), t(d), tc)
    return ({k: np.asarray(v) for k, v in jf._asdict().items()}, {k: v.numpy() for k, v in tf._asdict().items()},
            g, d, jc, tc)


@pytest.mark.parametrize("preset,distort", [("tum1_config", True), ("icl_config", False)])
def test_front_end_matches_jax(preset, distort):
    jf, tf, *_, tc = _front_pair(preset, distort)
    assert tc.camera.has_distortion == distort and (tc.camera.fy < 0) == (preset == "icl_config")
    m = (jf["octave"] == 0) & jf["valid"]
    assert m.sum() > 20
    np.testing.assert_array_equal(tf["valid"], jf["valid"])
    for key in ("octave", "depth"):
        np.testing.assert_array_equal(tf[key][m], jf[key][m], err_msg=key)
    np.testing.assert_array_equal(tf["desc"][m].astype(np.uint32), jf["desc"][m])
    np.testing.assert_allclose(tf["obs"][m], jf["obs"][m], atol=1e-3, rtol=0)
    if distort:  # the undistortion moved the keypoints
        assert np.abs(tf["uv"][m] - jf["uv"][m]).max() <= 1e-3
        assert (np.linalg.norm(tf["uv"][m] - tf["uv"][m].round(), axis=1) > 1e-2).mean() > 0.5


def test_icl_geometry_matches_jax():
    """ICL's fy < 0 through the normals, the plane segmentation and the 3D
    line fit."""
    *_, g, d, jc, tc = _front_pair("icl_config", False)
    n_j, ok_j = jplanes.compute_normals(jnp.asarray(d), jc.camera)
    n_t, ok_t = tplanes.compute_normals(t(d), tc.camera)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6, rtol=0)
    ps_j = jplanes.segment_planes(jnp.asarray(d), jc.camera)
    ps_t = tplanes.segment_planes(t(d), tc.camera)
    v = np.asarray(ps_j.valid)
    assert v.sum() >= 1
    np.testing.assert_array_equal(ps_t.valid.numpy(), v)
    np.testing.assert_array_equal(ps_t.block_label.numpy(), np.asarray(ps_j.block_label))
    np.testing.assert_allclose(ps_t.planes.numpy()[v], np.asarray(ps_j.planes)[v], atol=1e-4, rtol=0)
    lf = jlines.detect_lines(jnp.asarray(g, jnp.float32))
    tf = tlines.detect_lines(t(g))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(lf.valid))
    want = [np.asarray(a) for a in jl3.fit_lines_3d(jnp.asarray(d), jc.camera, lf.p0, lf.p1, lf.valid)]
    got = [a.numpy() for a in tl3.fit_lines_3d(t(d), tc.camera, t(np.asarray(lf.p0)), t(np.asarray(lf.p1)),
                                                t(np.asarray(lf.valid)))]
    np.testing.assert_array_equal(got[2], want[2])
    v = want[2]
    assert v.sum() >= 3
    same = np.maximum(np.abs(got[0] - want[0]).max(1), np.abs(got[1] - want[1]).max(1))
    swapped = np.maximum(np.abs(got[0] - want[1]).max(1), np.abs(got[1] - want[0]).max(1))
    assert (np.minimum(same, swapped)[v] <= 1e-5).all()


# (e) ---------------------------------------------------------------------

SLICE_FRAMES = 4


def _pose_gap(Ta, Tb):
    """(mm, deg) between two poses; the angle from the skew part of the
    relative rotation in float64."""
    D = Ta.astype(np.float64) @ np.linalg.inv(Tb.astype(np.float64))
    R = D[:3, :3]
    sin = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    rot = np.degrees(np.arctan2(sin, 0.5 * (np.trace(R) - 1)))
    return 1e3 * float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])), float(rot)


def _records(tr, grays, depths, T0):
    out = []
    for g, d in zip(grays, depths):
        r = tr.track_rgbd(g, d, T_cw_init=T0)
        llo = tr._last_line_out
        out.append(dict(T=np.asarray(r.T_cw), state=r.state.name, n=int(r.n_matches),
                        lines=0 if llo is None else int((np.asarray(llo[2]) >= 0).sum())))
    return out


@pytest.fixture(scope="module")
def slanted_frames(tmp_path_factory):
    """Frames 0-3 of the slanted protocol (adversarial.frames("slanted")),
    rendered by the port on the CPU."""
    return shared_result(tmp_path_factory, "adversarial_slanted_frames", lambda: tsyn.render_sequence(
        n=SLICE_FRAMES, scene=tsyn.make_adversarial_room(**SCENES["slanted"]), seed=3))


@pytest.fixture(scope="module")
def jax_slanted(tmp_path_factory, slanted_frames):
    def run():
        T_wc, grays, depths = slanted_frames
        tr = JaxTracker(jconfig.tum3_config(), use_local_ba=True, use_loop_closing=False)
        return _records(tr, grays, depths, np.linalg.inv(T_wc[0]))

    return shared_result(tmp_path_factory, "adversarial_slanted_jax", run)


def test_tracker_on_slanted_scene_matches_jax(slanted_frames, jax_slanted):
    T_wc, grays, depths = slanted_frames
    tr = Tracker(tconfig.tum3_config(), "cpu", use_local_ba=True, use_loop_closing=False)
    got = _records(tr, grays, depths, np.linalg.inv(T_wc[0]))
    for i, (a, b) in enumerate(zip(got, jax_slanted)):
        dt, dr = _pose_gap(a["T"], b["T"])
        assert a["state"] == b["state"] == "OK", i
        assert dt < 2.0 and dr < 0.1, (i, dt, dr)
    n_j = sum(r["n"] for r in jax_slanted[1:])
    l_j = sum(r["lines"] for r in jax_slanted[1:])
    assert n_j > 0 and l_j > 0
    assert sum(r["n"] for r in got[1:]) >= 0.75 * n_j
    assert sum(r["lines"] for r in got[1:]) >= 0.75 * l_j


# The parameters that came with the public functions ----------------------

_SIGNATURES = [
    ("solve.global_ba", "build_global_ba_problem", ("max_edges", "max_line_edges")),
    ("solve.ba", "local_bundle_adjustment", ("n_iters1", "n_iters2", "chi2_mono", "chi2_stereo", "chi2_line")),
    ("parallel.dist_ba", "dist_local_bundle_adjustment",
     ("n_iters1", "n_iters2", "chi2_mono", "chi2_stereo", "chi2_line")),
    ("mapping.local_mapping", "LocalMapper.create_new_map_points", ("max_neighbors",)),
    ("mapping.local_mapping", "LocalMapper.create_new_map_lines", ("max_neighbors",)),
    ("tracking.tracker", "Tracker.warmup", ("gray", "depth")),
    ("parallel.multiseq", "BatchTracker.warmup", ("gray", "depth")),
]


@pytest.mark.parametrize("mod,name,params", _SIGNATURES, ids=[s[1] for s in _SIGNATURES])
def test_parameters_and_defaults_match_jax(mod, name, params):
    import importlib
    import inspect

    def sig(pkg):
        obj = importlib.import_module(f"{pkg}.{mod}")
        for part in name.split("."):
            obj = getattr(obj, part)
        return inspect.signature(obj).parameters

    want, got = sig("hfvo_tpu"), sig("hfvo_tpu_torch")
    for p in params:
        assert p in got, p
        if want[p].default is not inspect.Parameter.empty:
            assert got[p].default == want[p].default, (p, got[p].default, want[p].default)


def test_local_bundle_adjustment_options_match_jax():
    """Fewer iterations and tighter gates than the defaults: the same
    inliers and poses as the JAX package (test_torch_ba.py's gates), and
    the 1-rank distributed solve equal to the single-device one."""
    import jax

    from hfvo_tpu.solve import ba as jba
    from hfvo_tpu.testing.ba_fixture import synthetic_ba_problem
    from hfvo_tpu_torch.parallel.dist_ba import dist_local_bundle_adjustment, shard_ba_problem
    from hfvo_tpu_torch.parallel.mesh import make_mesh
    from hfvo_tpu_torch.solve import ba as tba
    from test_torch_ba import JCAM, TCAM, _compare, _to_port

    kw = dict(n_iters1=2, n_iters2=4, chi2_mono=3.0, chi2_stereo=4.5, chi2_line=2.0)
    prob, T_gt = synthetic_ba_problem(JCAM, n_blocks=2, K=6, pts_per_block=40)
    want = jax.device_get(jba.local_bundle_adjustment(prob, JCAM, **kw))
    got = tba.local_bundle_adjustment(_to_port(prob), TCAM, **kw)
    _compare(want, got, T_gt, 80)
    default = tba.local_bundle_adjustment(_to_port(prob), TCAM)
    assert not torch.equal(default.kf_T_cw, got.kf_T_cw)  # the options reach the solver
    kf_T = dist_local_bundle_adjustment(make_mesh(), shard_ba_problem(_to_port(prob), 1), TCAM, **kw,
                                        device="cpu")[0]
    np.testing.assert_allclose(kf_T.numpy(), got.kf_T_cw.numpy(), atol=1e-5, rtol=0)


def test_tracker_warmup_leaves_the_tracker_as_it_was():
    from hfvo_tpu_torch.parallel.multiseq import BatchTracker
    from torch_helpers import half_camera

    cfg = tconfig.tum3_config().replace(camera=half_camera())
    T_wc, g, d = tsyn.render_sequence(n=2, intr=cfg.camera)
    tr = Tracker(cfg, "cpu")
    tr.warmup(g[0], d[0])  # builds the kernels (nothing on the CPU); the frame is unused
    tr.track_rgbd(g[0], d[0])
    before = (tr.T_cw.copy(), tr.velocity.copy(), tr.frame_id, tr.state, int(tr.vomap.points.valid.sum()),
              tr.vomap.kf_order_counter)
    tr.warmup(g[1], d[1])
    after = (tr.T_cw, tr.velocity, tr.frame_id, tr.state, int(tr.vomap.points.valid.sum()),
             tr.vomap.kf_order_counter)
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)
    assert tr.track_rgbd(g[1], d[1]).state.name == "OK"
    bt = BatchTracker(cfg, 2, "cpu")
    bt.warmup()
    bt.warmup(g[0], d[0])


# The public surface, module by module ------------------------------------

# What the port leaves out on purpose (ROADMAP.md, "The public surface"):
# the Pallas modules (the kernels are hfvo_tpu_torch/csrc/*.cu), the
# two-buffer wire format and the dispatch split around it, the TPU's BRIEF
# matmul bank, the `jax.jit` wrappers, closures nested in functions,
# `build_global_ba_problem`'s `pad` (power-of-two tables for XLA's program
# cache) and `warp_points_by_rotation`'s `n_samples` (unused there too).
SURFACE_EXCEPTIONS = {
    ("MODULE", "ops/pallas_fast.py", ""), ("MODULE", "ops/pallas_hough.py", ""),
    ("MODULE", "utils/__init__.py", ""), ("MODULE", "utils/pack.py", ""),
    ("NAME", "tracking/tracker.py", "fused_out_meta"), ("NAME", "tracking/tracker.py", "lk_recover_program"),
    ("NAME", "tracking/tracker.py", "Tracker.prepare_step_args"),
    ("NAME", "tracking/tracker.py", "Tracker.prepare_step_args_host"),
    ("PARAMS", "tracking/tracker.py", "Tracker.finish_step: out_host, gray"),
    ("NAME", "ops/orb.py", "BIN_DIFF_MATS"),
    ("NAME", "testing/synthetic.py", "render_jit"), ("NAME", "tracking/frontend.py", "extract_frame_jit"),
    ("PARAMS", "solve/global_ba.py", "build_global_ba_problem: pad"),
    ("PARAMS", "ops/lk.py", "warp_points_by_rotation: n_samples"),
}


def _surface(root):
    """{module path: {public name: parameter names (None for a class or a
    module-level assignment)}}: functions, classes, their methods
    (`__init__` included) and module-level names; closures are skipped."""
    import ast
    import os

    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dp, f)
            names = out[os.path.relpath(path, root)] = {}
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
                    names[node.name] = [a.arg for a in node.args.args + node.args.kwonlyargs]
                elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                    names[node.name] = None
                    for sub in node.body:
                        if isinstance(sub, ast.FunctionDef) and (not sub.name.startswith("_")
                                                                 or sub.name == "__init__"):
                            names[f"{node.name}.{sub.name}"] = [a.arg for a in sub.args.args + sub.args.kwonlyargs]
                elif isinstance(node, ast.Assign):
                    names.update({tg.id: None for tg in node.targets
                                  if isinstance(tg, ast.Name) and not tg.id.startswith("_")})
    return out


def test_public_surface_matches_jax():
    """Every public module, name and parameter of hfvo_tpu has its
    counterpart in hfvo_tpu_torch, but the deliberate exceptions."""
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want, got = _surface(os.path.join(here, "hfvo_tpu")), _surface(os.path.join(here, "hfvo_tpu_torch"))
    missing = set()
    for mod, names in want.items():
        if mod not in got:
            missing.add(("MODULE", mod, ""))
            continue
        for name, params in names.items():
            if name not in got[mod]:
                missing.add(("NAME", mod, name))
            elif params and got[mod][name] is not None:
                lost = [p for p in params if p not in got[mod][name]]
                if lost:
                    missing.add(("PARAMS", mod, f"{name}: {', '.join(lost)}"))
    assert missing == SURFACE_EXCEPTIONS, (sorted(missing - SURFACE_EXCEPTIONS), sorted(SURFACE_EXCEPTIONS - missing))
