"""The control, the reference one precision below the configuration's
float32 (TF32) put in the program's place, fails the cell's limits; the
program's own plain CPU versions pass them. At the cell's size on one
rendered frame (the chip's readings over many seeds are in PERF.md,
from hfvo_bench/control.py); the card's version is marked `cuda`."""
import json
import math

import pytest
import torch

from hfvo_bench import check, gen
from hfvo_bench.reference import ba as ref_ba

from .conftest import ROOT

CFG = json.loads((ROOT / "hfvo_bench/configs/tum3_vo.json").read_text())
CAM = CFG["vo_config"]["camera"]
CELLS = ("vo_orbit", "batch8_orbit")


def _limits(cell):
    return json.loads((ROOT / f"hfvo_bench/limits/{cell}.json").read_text())["limits"]


def _sample(device="cpu"):
    """One rendered, sensorized frame and the program's kernels' plain
    versions on it, as a capture would hold them."""
    from hfvo_tpu_torch.config import tum3_config
    from hfvo_tpu_torch.ops import fast, image, lines

    p = gen.load_params(ROOT / "hfvo_bench", "orbit_textured")
    tr = gen.build("orbit_textured", p, CAM, 30.0, 1, 2**31 + 99, device, n_render=1)
    cfg = tum3_config()
    g = torch.from_numpy(tr.gray[:1]).to(device)
    levels = [x.contiguous() for x in image.build_pyramid(g.float(), cfg.orb.n_levels, cfg.orb.scale_factor)]
    out = fast.fast_score_dual_levels(levels, 7.0, 20.0)
    gx, gy = image.sobel_gradients(g.float())
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx), math.pi)
    acc = lines.hough_vote(mag, ang, 12.0)
    smp = dict(tag=[0], fast=dict(levels=levels, out=out, th_low=7.0, th_high=20.0, bonus=1e4),
               hough=dict(mag=mag, ang=ang, out=acc, mag_th=12.0))
    return tr, cfg, smp


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes_the_kernel_limits(cell):
    tr, cfg, smp = _sample()
    lim = _limits(cell)
    prog = check.kernel_numbers([smp], tr, cfg)
    ctrl = check.kernel_numbers([smp], tr, cfg, tf32=True)
    for name, v in prog.items():
        assert v <= lim[name], (name, v, lim[name])
    failed = [name for name, v in ctrl.items() if v > lim[name]]
    assert failed == list(ctrl), (ctrl, lim)  # the control fails every kernel number


def _ba_problem(seed=0, K=4, P=300):
    """A small local BA problem with exact observations of noisy landmarks,
    solved by the program's BA on the CPU."""
    from hfvo_tpu_torch.geometry.camera import Intrinsics
    from hfvo_tpu_torch.solve.ba import BAProblem, local_bundle_adjustment

    g = torch.Generator().manual_seed(seed)
    intr = Intrinsics(**CAM)
    X = torch.rand((P, 3), generator=g) * torch.tensor([2.0, 1.5, 1.0]) - torch.tensor([1.0, 0.75, -2.0])
    T = torch.eye(4).repeat(K, 1, 1)
    T[:, 0, 3] = torch.linspace(0, 0.3, K)
    e_kf = torch.arange(K).repeat_interleave(P)
    e_pt = torch.arange(P).repeat(K)
    Xc = torch.einsum("nij,nj->ni", T[e_kf, :3, :3], X[e_pt]) + T[e_kf, :3, 3]
    u = CAM["fx"] * Xc[:, 0] / Xc[:, 2] + CAM["cx"]
    v = CAM["fy"] * Xc[:, 1] / Xc[:, 2] + CAM["cy"]
    obs = torch.stack([u, v, u - CAM["bf"] / Xc[:, 2]], -1) + 0.5 * torch.randn((K * P, 3), generator=g)
    E = K * P
    prob = BAProblem(
        kf_T_cw=T, kf_free=torch.arange(K) > 0, pt_X=X + 0.01 * torch.randn((P, 3), generator=g),
        pt_valid=torch.ones(P, dtype=torch.bool), e_kf=e_kf, e_pt=e_pt, e_obs=obs,
        e_stereo=torch.ones(E, dtype=torch.bool), e_inv_sigma2=torch.ones(E),
        e_valid=torch.ones(E, dtype=torch.bool), **BAProblem.empty_line_edges())
    return dict(prob=prob, res=local_bundle_adjustment(prob, intr))


BA_NAMES = check.BA_NUMBERS


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes_the_ba_limits(cell):
    lim = _limits(cell)
    for seed in range(3):
        ba = _ba_problem(seed)
        prog = check.ba_numbers(ba, CAM)
        assert all(prog[n] <= lim[n] for n in BA_NAMES if n in lim), prog
        ctrl = check.ba_numbers(ba, CAM, tf32=True)
        assert any(ctrl[n] > lim[n] for n in BA_NAMES if n in lim), ctrl


@pytest.mark.parametrize("cell, fault", [("vo_orbit", "no_op"), ("vo_orbit", "all_outliers"),
                                         ("batch8_orbit", "all_outliers")])
def test_ba_faults_fail_the_ba_limits(cell, fault):
    """A solve that returns its input unchanged, and one that flags every
    edge an outlier with cost 0, each fail a BA number of the cells that
    compare it (`batch8_orbit` does not compare the point step, PERF.md)."""
    from types import SimpleNamespace

    from hfvo_tpu_torch.geometry.camera import Intrinsics
    from hfvo_tpu_torch.solve.ba import final_gate

    lim = _limits(cell)
    ba = _ba_problem(4)
    p, r = ba["prob"], ba["res"]
    if fault == "no_op":
        bad = final_gate(p, p.kf_T_cw, p.pt_X, Intrinsics(**CAM))
        names = ("ba_point_step_gain",)
    else:
        bad = SimpleNamespace(kf_T_cw=r.kf_T_cw, pt_X=r.pt_X, e_inlier=torch.zeros_like(r.e_inlier),
                              le_inlier=torch.zeros_like(r.le_inlier), chi2=torch.zeros(()))
        names = ("ba_chi2_rel_err", "ba_flags_wrong")
    got = check.ba_numbers(dict(prob=p, res=bad), CAM)
    assert all(got[n] > lim[n] for n in names), got


def test_ba_reference_cost_is_the_published_cost():
    ba = _ba_problem(1)
    p, r = ba["prob"], ba["res"]
    X = r.pt_X.double()[p.e_pt]
    T = r.kf_T_cw.double()[p.e_kf]
    Xc = (T[:, :3, :3] @ X[..., None])[..., 0] + T[:, :3, 3]
    u = CAM["fx"] * Xc[:, 0] / Xc[:, 2] + CAM["cx"]
    v = CAM["fy"] * Xc[:, 1] / Xc[:, 2] + CAM["cy"]
    res = torch.stack([u, v, u - CAM["bf"] / Xc[:, 2]], -1) - p.e_obs.double()
    want = float((res ** 2).sum(-1)[r.e_inlier].sum())
    tm = ref_ba.Terms(p, CAM, torch.float64, lambda x: x)
    got = tm.edge_cost(r.kf_T_cw.double(), r.pt_X.double(), r.e_inlier, r.le_inlier)
    assert float(got) == pytest.approx(want, rel=1e-12)


def test_ba_reference_step_is_gauss_newton():
    """From a perturbed state, the reference step's first-order change of
    the cost is the negative of the step against the gradient (a descent
    direction), and its solve reaches the program's cost."""
    ba = _ba_problem(2)
    p, r = ba["prob"], ba["res"]
    tm = ref_ba.Terms(p, CAM, torch.float64, lambda x: x)
    T, X = p.kf_T_cw.double(), p.pt_X.double()
    use, luse = p.e_valid, p.le_valid
    dxi, dX = ref_ba.gn_step(tm, T, X, use, luse, 1e-6)
    xi = torch.zeros_like(dxi, requires_grad=True)
    d = torch.zeros_like(dX, requires_grad=True)
    tm.cost(*ref_ba.apply(T, X, xi, d), use, luse).backward()
    slope = float((xi.grad * dxi).sum() + (d.grad * dX).sum())
    assert slope < 0
    assert float(tm.cost(*ref_ba.apply(T, X, dxi, dX), use, luse)) < float(tm.cost(T, X, use, luse))
    sol = ref_ba.solve(p, CAM)
    e_in, le_in = r.e_inlier, r.le_inlier
    assert float(tm.cost(sol.kf_T_cw, sol.pt_X, e_in, le_in)) == pytest.approx(
        float(tm.cost(r.kf_T_cw.double(), r.pt_X.double(), e_in, le_in)), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    """control.py's readings at the cell's size on the card: every program
    number within its limit, every control kernel number beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "hfvo_bench/control.py", "--workload", cell, "--seeds", "2147483659",
                          "--seconds", "12"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    lim = _limits(cell)
    assert line["correct"]
    for name, v in line["control"].items():
        if name in ("pyramid_max_abs_err", "fast_max_abs_err", "sobel_mag_max_abs_err", "sobel_ang_max_abs_err",
                    "hough_max_rel_err") or (name in ("ba_chi2_rel_err", "ba_point_step_gain") and name in lim
                                             and v is not None):
            assert float(v) > lim[name], (name, v)
