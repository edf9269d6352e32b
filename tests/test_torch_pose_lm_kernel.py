"""The pose LM's CUDA kernel (`csrc/pose_lm.cu`) against its plain version
(`pose_optimization_reference`), on the card, and the wrapper's dispatch
and checks on the CPU.

This file imports no JAX, so it runs on a machine with a GPU and no JAX
(tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m cuda tests/test_torch_pose_lm_kernel.py

Scenes: those of tests/test_torch_pose_opt.py (clean stereo, clean mixed,
outliers, all invalid; the outlier scene with the metric 3D term; the line
and direction scene at (n_rounds, n_iters) = (1, 2), (1, 4), (4, 10) and
(2, 8), the last being PnP's refinement) and of tests/test_torch_planes.py
(plane and axis edges), built with the port's se3 and camera in place of
the JAX package's.

Tolerances, kernel against the plain version on the same CUDA inputs:
T_cw within 1e-5 (the JAX parity tests' tolerance: both visit the same
(pose, lambda) sequence and differ only in the float32 sum order of the 6x6
normal equations), identical inlier masks and n_inliers, chi2 within 1e-3
relative. A sequence of an S = 8 stack equals its own S = 1 launch bit for
bit (one block a sequence, fixed-order reductions), as do two launches on
the same inputs."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hfvo_tpu_torch import tracing
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.geometry import camera as tcam
from hfvo_tpu_torch.geometry import se3
from hfvo_tpu_torch.solve import lm as tlm
from hfvo_tpu_torch.solve import residuals
from torch_helpers import cuda_device  # noqa: F401

INTR = tum3_config().camera
N_EDGES = 300
SCENES = ["clean_stereo", "clean_mixed", "outliers", "all_invalid", "outliers_3d",
          "lines_1_2", "lines_1_4", "lines_4_10", "lines_2_8", "planes_axes"]


def _exp(xi):
    return se3.exp_se3(torch.tensor(np.asarray(xi, np.float32))).numpy()


def _twist_pose(xi, T):
    return (_exp(xi) @ T).astype(np.float32)


def _point_scene(rng, n, noise=0.0, outlier_frac=0.0):
    X_w = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.0, 6.0, n)],
                   axis=1).astype(np.float32)
    T_cw = _exp([0.1, -0.05, 0.08, 0.04, -0.03, 0.06])
    X_c = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    obs = tcam.project_stereo(INTR, torch.from_numpy(X_c.astype(np.float32))).numpy()
    obs[:, :2] += rng.normal(size=(n, 2)) * noise
    n_out = int(n * outlier_frac)
    if n_out:
        obs[:n_out, :2] += rng.uniform(20, 80, size=(n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return T_cw, X_w, obs.astype(np.float32)


def _pose_obs(X_w, obs, stereo, valid, **extra):
    n = len(X_w)
    is_st = np.full((n,), stereo) if np.isscalar(stereo) else stereo
    return tlm.PoseObs(X_w=X_w, obs=obs, is_stereo=is_st, inv_sigma2=np.ones((n,), np.float32),
                       valid=valid, **extra)


def _line_scene(rng):
    """tests/test_torch_pose_opt.py::_line_scene: 100 noisy mixed point
    edges, 40 map lines as 80 endpoint edges (4 mismatched), 40 direction
    edges with random sign flips (4 wrong)."""
    T, X, obs = _point_scene(rng, 100, noise=0.5)
    stereo = rng.uniform(size=100) < 0.5
    L = 40
    A = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(2.5, 6, L)], 1)
    B = A + rng.normal(size=(L, 3)) * 0.6
    Xw = np.concatenate([A, B]).astype(np.float32)
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    uv = tcam.project(INTR, torch.from_numpy(Xc.astype(np.float32))).numpy().astype(np.float64)
    q0, q1 = uv[:L], uv[L:]
    q1[:4] += 40.0
    l2 = np.cross(np.concatenate([q0, np.ones((L, 1))], 1), np.concatenate([q1, np.ones((L, 1))], 1))
    l2 /= np.linalg.norm(l2[:, :2], axis=1, keepdims=True)
    lvalid = np.ones(2 * L, bool)
    lvalid[L - 1] = lvalid[-1] = False
    dw = (B - A) / np.linalg.norm(B - A, axis=1, keepdims=True)
    dc = dw @ T[:3, :3].T + rng.normal(size=(L, 3)) * 0.01
    dc[:4] = rng.normal(size=(4, 3))
    dc /= np.linalg.norm(dc, axis=1, keepdims=True)
    dc *= rng.choice([-1.0, 1.0], (L, 1))
    dvalid = np.ones(L, bool)
    dvalid[5] = False
    T0 = _twist_pose([0.03, -0.02, 0.03, 0.03, -0.02, 0.03], T)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return T0, T, dict(
        pts=_pose_obs(X, obs, stereo, np.ones(len(X), bool)),
        lines=tlm.LineObs(Xw, f32(np.concatenate([l2, l2])), np.ones(2 * L, np.float32), lvalid),
        dirs=tlm.DirObs(f32(dw), f32(dc), np.ones(L, np.float32), dvalid),
    )


def _plane_scene(rng):
    """tests/test_torch_planes.py::_lm_scene: 150 noisy stereo points, 10
    plane edges (6 full, one 1.2 m off, 2 parallel, 2 vertical) and 3 axis
    anchors (one off)."""
    n = 150
    X_w = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.0, 6.0, n)], 1).astype(np.float32)
    T = _exp([0.1, -0.05, 0.08, 0.04, -0.03, 0.06])
    X_c = X_w @ T[:3, :3].T + T[:3, 3]
    obs = np.stack([INTR.fx * X_c[:, 0] / X_c[:, 2] + INTR.cx, INTR.fy * X_c[:, 1] / X_c[:, 2] + INTR.cy], 1)
    obs = np.concatenate([obs, obs[:, :1] - INTR.bf / X_c[:, 2:]], 1) + rng.normal(size=(n, 3)) * 0.4
    axes_w = se3.exp_so3(torch.tensor([0.2, -0.4, 0.1])).numpy()
    n_w = np.concatenate([axes_w, -axes_w, axes_w, axes_w[:1]])[:10]
    pi_w = np.concatenate([n_w, rng.uniform(-3, -1, (10, 1))], 1).astype(np.float32)
    n_c = n_w @ T[:3, :3].T
    d_c = pi_w[:, 3] - n_c @ T[:3, 3]
    kind = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2], np.int32)
    pi_obs = np.concatenate([n_c + rng.normal(size=(10, 3)) * 0.005, d_c[:, None] + 0.003], 1)
    pi_obs[8:, :3] = np.cross(n_c[8:], rng.normal(size=(2, 3)))
    pi_obs[:, :3] /= np.linalg.norm(pi_obs[:, :3], axis=1, keepdims=True)
    pi_obs[6:, 3] = rng.uniform(-3, 3, 4)
    pi_obs[5, 3] += 1.2
    weight = np.where((kind == 0)[:, None], [[0.5, 0.5, 100.0]], [[0.5, 0.0, 0.0]]).astype(np.float32)
    chi2_th = np.where(kind == 0, 100.0, 50.0).astype(np.float32)
    axes_c = (axes_w @ T[:3, :3].T + rng.normal(size=(3, 3)) * 0.002).astype(np.float32)
    T0 = _twist_pose([0.03, -0.02, 0.02, 0.03, -0.02, 0.02], T)
    return T0, T, dict(
        pts=_pose_obs(X_w, obs.astype(np.float32), True, np.ones(n, bool)),
        planes=tlm.PlaneObs(pi_w, pi_obs.astype(np.float32), kind, weight, chi2_th, np.ones(10, bool)),
        axes_c=axes_c, axes_w=axes_w.astype(np.float32), w_axis=np.array([1e5, 5e4, 0.0], np.float32),
    )


def make_scene(name):
    """(T0, the true pose, pose_optimization's keyword arguments as numpy)."""
    rng = np.random.default_rng(0)
    if name == "clean_stereo":
        T, X, obs = _point_scene(rng, N_EDGES)
        return _twist_pose([0.05, -0.03, 0.02, 0.02, 0.01, -0.02], T), T, dict(
            pts=_pose_obs(X, obs, True, np.ones(N_EDGES, bool)))
    if name == "clean_mixed":
        T, X, obs = _point_scene(rng, N_EDGES, noise=0.3)
        stereo = rng.uniform(size=N_EDGES) < 0.5
        return _twist_pose([0.03, 0.02, -0.02, -0.01, 0.02, 0.01], T), T, dict(
            pts=_pose_obs(X, obs, stereo, np.ones(N_EDGES, bool)))
    if name in ("outliers", "outliers_3d"):
        T, X, obs = _point_scene(rng, N_EDGES, noise=0.5, outlier_frac=0.2)
        T0 = _twist_pose([0.05, 0.02, -0.03, 0.01, -0.02, 0.02], T)
        if name == "outliers":
            return T0, T, dict(pts=_pose_obs(X, obs, True, np.ones(N_EDGES, bool)))
        # tests/test_torch_pose_opt.py's metric 3D scene: 1 cm depth noise,
        # 10 % of the points 0.3-1 m off, the 3D edges on a valid_3d mask.
        rng = np.random.default_rng(5)
        X_c = (X @ T[:3, :3].T + T[:3, 3] + rng.normal(size=X.shape) * 0.01).astype(np.float32)
        X_c[: N_EDGES // 10] += rng.uniform(0.3, 1.0, (N_EDGES // 10, 3)).astype(np.float32)
        valid_3d = rng.uniform(size=N_EDGES) < 0.8
        return T0, T, dict(pts=_pose_obs(X, obs, True, np.ones(N_EDGES, bool), X_c_obs=X_c, valid_3d=valid_3d),
                           inv_sigma2_3d=400.0)
    if name == "all_invalid":
        z = np.zeros((N_EDGES, 3), np.float32)
        return np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32), dict(
            pts=_pose_obs(z, z, True, np.zeros(N_EDGES, bool)))
    if name.startswith("lines_"):
        T0, T, kw = _line_scene(np.random.default_rng(7))
        n_rounds, n_iters = map(int, name.split("_")[1:])
        return T0, T, dict(kw, n_rounds=n_rounds, n_iters=n_iters)
    if name == "planes_axes":
        return _plane_scene(np.random.default_rng(11))
    raise KeyError(name)


def to_device(kw, device):
    """numpy leaves (tuples of them included) -> tensors on `device`."""
    def conv(a):
        if isinstance(a, tuple):
            return type(a)(*(conv(x) for x in a))
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.array(a)).to(device)
        return a
    return {k: conv(v) for k, v in kw.items()}


def _solve(fn, T0, kw, device):
    return fn(torch.from_numpy(np.array(T0, np.float32)).to(device), intr=INTR, **to_device(kw, device))


def assert_matches(got, want):
    """The kernel's result against the plain version's (module docstring)."""
    got, want = [[x.cpu() for x in r] for r in (got, want)]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5, rtol=0)
    for i in (1, 4, 5):  # point, line and plane inlier masks
        assert got[i].dtype == want[i].dtype == torch.bool and torch.equal(got[i], want[i])
    assert got[2].dtype == want[2].dtype == torch.int64 and torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-3, atol=1e-3)


def assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


# ---- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("scene", SCENES)
def test_kernel_matches_plain_version_on_card(cuda_device, scene):
    T0, _, kw = make_scene(scene)
    before = tlm.pose_lm_launches
    got = _solve(tlm.pose_optimization, T0, kw, cuda_device)
    assert tlm.pose_lm_launches == before + 1
    want = _solve(tlm.pose_optimization_reference, T0, kw, cuda_device)
    torch.cuda.synchronize()
    assert all(x.device == cuda_device for x in got)
    assert_matches(got, want)


def _stack(scenes):
    """S scenes of one layout -> one (S, ...) problem."""
    T0 = np.stack([s[0] for s in scenes])
    kw = {}
    for k, v in scenes[0][2].items():
        if isinstance(v, tuple):
            kw[k] = type(v)(*(None if x is None else np.stack([s[2][k][i] for s in scenes])
                              for i, x in enumerate(v)))
        elif isinstance(v, np.ndarray):
            kw[k] = np.stack([s[2][k] for s in scenes])
        else:
            kw[k] = v
    return T0, kw


def _batch_scenes():
    """8 line-and-direction scenes from other starts, with other point
    noise: their sequences converge after different numbers of iterations."""
    T0, T, kw = make_scene("lines_4_10")
    rng = np.random.default_rng(11)
    out = []
    for k, scale in enumerate((1.0, -0.5, 2.0, 0.1, -1.5, 3.0, 0.5, -2.5)):
        pts = kw["pts"]._replace(obs=(kw["pts"].obs + np.concatenate(
            [rng.normal(size=(len(kw["pts"].obs), 2)) * 0.3 * k, np.zeros((len(kw["pts"].obs), 1))],
            1)).astype(np.float32))
        out.append((_twist_pose(np.array([0.01, 0.02, -0.01, 0.01, 0.02, -0.01]) * scale, T0), T, dict(kw, pts=pts)))
    return out


def _builds(T0, kw):
    """Normal-equation builds of the plain version on the CPU: every build,
    every round's re-classification and the final chi2 evaluate the point
    terms once."""
    calls = [0]
    inner = residuals.point_stereo_terms_t

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    residuals.point_stereo_terms_t = counted
    try:
        _solve(tlm.pose_optimization_reference, T0, kw, "cpu")
    finally:
        residuals.point_stereo_terms_t = inner
    return calls[0] - kw["n_rounds"] - 1


@pytest.mark.cuda
def test_batch_of_8_is_each_sequence_alone_on_card(cuda_device):
    scenes = _batch_scenes()
    builds = [_builds(s[0], s[2]) for s in scenes]
    assert len(set(builds)) > 1, builds  # the sequences converge at different iterations
    T0, kw = _stack(scenes)
    before = tlm.pose_lm_launches
    batch = _solve(tlm.pose_optimization, T0, kw, cuda_device)
    assert tlm.pose_lm_launches == before + 1
    assert_matches(batch, _solve(tlm.pose_optimization_reference, T0, kw, cuda_device))
    for k, (T0_k, _, kw_k) in enumerate(scenes):
        alone = _solve(tlm.pose_optimization, T0_k, kw_k, cuda_device)
        assert_same([x[k] for x in batch], alone)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["outliers_3d", "lines_4_10", "planes_axes"])
def test_kernel_repeats_bit_for_bit_on_card(cuda_device, scene):
    T0, _, kw = make_scene(scene)
    first = _solve(tlm.pose_optimization, T0, kw, cuda_device)
    assert_same(first, _solve(tlm.pose_optimization, T0, kw, cuda_device))


@pytest.mark.cuda
def test_kernel_never_waits_on_the_device(cuda_device):
    """No host sync in the wrapper: the 3D term, lines, directions, planes
    and axis anchors with a device w_axis, under the sync debug mode's
    "error" (which raises on any synchronizing call)."""
    T0, _, kw = make_scene("outliers_3d")
    _, _, line_kw = make_scene("lines_4_10")
    _, _, plane_kw = make_scene("planes_axes")
    n = len(kw["pts"].X_w)
    args = to_device(dict(pts=kw["pts"], lines=line_kw["lines"], dirs=line_kw["dirs"], planes=plane_kw["planes"],
                          axes_c=plane_kw["axes_c"], axes_w=plane_kw["axes_w"], w_axis=plane_kw["w_axis"],
                          inv_sigma2_3d=400.0), cuda_device)
    T = torch.from_numpy(T0).to(cuda_device)
    tlm.pose_optimization(T, intr=INTR, **args)  # builds and loads the library
    torch.cuda.synchronize()
    before = tlm.pose_lm_launches
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tlm.pose_optimization(T, intr=INTR, **args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert tlm.pose_lm_launches == before + 1
    assert out.inlier.shape == (n,) and out.plane_inlier.shape == (10,)
    assert_matches(out, tlm.pose_optimization_reference(T, intr=INTR, **args))


@pytest.mark.cuda
def test_kernel_counts_one_launch_a_call_on_card(cuda_device):
    """One launch and one `lm_kernel` count a call at S = 1 and S = 8, and
    no convergence test (`lm_test`) on the host."""
    T0, _, kw = make_scene("lines_4_10")
    T0b, kwb = _stack(_batch_scenes())
    tracing.disable()
    tracing.drain()
    before = tlm.pose_lm_launches
    tracing.enable()
    try:
        for _ in range(2):
            _solve(tlm.pose_optimization, T0, kw, cuda_device)
            _solve(tlm.pose_optimization, T0b, kwb, cuda_device)
    finally:
        tracing.disable()
    counts = {}
    for c in tracing.drain().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    assert tlm.pose_lm_launches == before + 4
    assert counts.get("lm_kernel") == 4 and "lm_test" not in counts


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card(cuda_device):
    T0, _, kw = make_scene("lines_4_10")
    before = tlm.pose_lm_launches
    for T, args in _bad_inputs(T0, kw, cuda_device):
        with pytest.raises(ValueError):
            tlm.pose_optimization(T, intr=INTR, **args)
    assert tlm.pose_lm_launches == before


# ---- on the CPU -----------------------------------------------------------


def _bad_inputs(T0, kw, device):
    """(pose, keyword arguments) the kernel's wrapper refuses: float64,
    wrong shapes, tables on another device, a non-integer plane kind, a
    w_axis that does not broadcast, axes_c without axes_w."""
    T = torch.from_numpy(T0).to(device)
    args = to_device(kw, device)
    pts, lines = args["pts"], args["lines"]
    _, _, pkw = make_scene("planes_axes")
    pargs = to_device(pkw, device)
    T_p = torch.from_numpy(make_scene("planes_axes")[0]).to(device)
    return [
        (T.double(), args),
        (T, dict(args, pts=pts._replace(obs=pts.obs.double()))),
        (T, dict(args, pts=pts._replace(obs=pts.obs[:-1]))),
        (T, dict(args, lines=lines._replace(valid=lines.valid.float()))),
        (T[None].expand(2, 4, 4), args),
        (T, dict(args, pts=pts._replace(valid=pts.valid.to("meta")))),
        (T_p, dict(pargs, planes=pargs["planes"]._replace(kind=pargs["planes"].kind.float()))),
        (T_p, dict(pargs, w_axis=pargs["w_axis"][:2])),
        (T_p, dict(pargs, axes_w=None)),
    ]


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrapper is the plain version: no launch, and the
    host's convergence tests are counted (`lm_test`), with its rounds'
    spans."""
    T0, _, kw = make_scene("lines_4_10")
    tracing.disable()
    tracing.drain()
    before = tlm.pose_lm_launches
    tracing.enable()
    try:
        with tracing.span("step.lm"):
            got = _solve(tlm.pose_optimization, T0, kw, "cpu")
    finally:
        tracing.disable()
    rec = tracing.drain()
    assert tlm.pose_lm_launches == before
    names = {c.name for c in rec.counts}
    assert "lm_test" in names and "lm_kernel" not in names
    assert sum(s.name == "lm.round" for s in rec.spans) == 4
    assert_same(got, _solve(tlm.pose_optimization_reference, T0, kw, "cpu"))


def test_other_devices_are_refused():
    T0, _, kw = make_scene("clean_stereo")
    with pytest.raises(ValueError):
        _solve(tlm.pose_optimization, T0, kw, "meta")


@pytest.mark.parametrize("case", range(9))
def test_launcher_refuses_bad_tables_before_any_launch(case):
    """The kernel's argument checks, which run before the library is built
    or loaded, on CPU tables (the last case: a table on another device)."""
    T0, _, kw = make_scene("lines_4_10")
    T, args = _bad_inputs(T0, kw, "cpu")[case]
    before = tlm.pose_lm_launches
    with pytest.raises(ValueError):
        tlm._launch(T, args["pts"], INTR, args.get("lines"), args.get("planes"), args.get("dirs"),
                    args.get("axes_c"), args.get("axes_w"), args.get("w_axis", 0.0), 4, 10, 5.991, 7.815,
                    3.84, 3.84, 7.815, 400.0)
    assert tlm.pose_lm_launches == before


def test_args_struct_matches_the_kernel_source():
    """The ctypes mirror of csrc/pose_lm.cu's HfvoPoseLmArgs: the same
    fields in the same order, pointers, ints and floats alike (the source
    is compiled only on the card)."""
    src = (Path(tlm.__file__).resolve().parents[1] / "csrc" / "pose_lm.cu").read_text()
    body = re.search(r"struct HfvoPoseLmArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "p" if "*" in decl.split(",")[0] else {"int": "i", "float": "f"}[decl.split()[0]]
        fields += [(name.strip().lstrip("*").strip(), kind) for name in
                   re.sub(r"^(const\s+)?\w+\s*\*?", "", decl).split(",")]
    kinds = {tlm.ctypes.c_void_p: "p", tlm.ctypes.c_int: "i", tlm.ctypes.c_float: "f"}
    assert fields == [(n, kinds[t]) for n, t in tlm._Args._fields_]


@pytest.mark.parametrize("scene", SCENES)
def test_card_scenes_are_solved_by_the_plain_version(scene):
    """The card tests' scenes are sound: on the CPU the plain version ends
    near the true pose (or, without edges, where it started), rejects the
    planted outliers and keeps most other edges."""
    T0, T_true, kw = make_scene(scene)
    got = _solve(tlm.pose_optimization, T0, kw, "cpu")
    T = got.T_cw.numpy()
    n_rounds = kw.get("n_rounds", 4)
    if scene == "all_invalid":
        np.testing.assert_array_equal(T, T0)
        assert int(got.n_inliers) == 0 and float(got.chi2) == 0.0
        return
    err = np.linalg.norm(T[:3, 3] - T_true[:3, 3])
    start = np.linalg.norm(T0[:3, 3] - T_true[:3, 3])
    assert np.isfinite(T).all() and err < 0.5 * start, (err, start)
    if n_rounds == 4:
        assert err < 0.01
        inl = got.inlier.numpy()
        if scene.startswith("outliers"):
            assert not inl[: N_EDGES // 5].any() and inl[N_EDGES // 5 :].mean() > 0.9
        if scene.startswith("lines"):
            assert not got.line_inlier.numpy()[40:44].any() and got.line_inlier.numpy().sum() >= 60
        if scene == "planes_axes":
            assert not got.plane_inlier[5] and got.plane_inlier.sum() >= 7
