"""search_by_projection against hfvo_tpu's on the fixtures of
tests/test_tracker.py (basic, view-cos gate, conflict) and on a cluttered
random scene with octaves, rotations and duplicate landmarks. Matching is
integer logic on float32 projections, so `pt_id_per_kp`, `n_matches` and
`visible` must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.config import tum3_config as jax_tum3
from hfvo_tpu.geometry import camera as jcam
from hfvo_tpu.geometry import se3 as jse3
from hfvo_tpu.tracking import matcher as jmatch
from hfvo_tpu_torch.config import tum3_config
from hfvo_tpu_torch.tracking import matcher as tmatch
from torch_helpers import t


def _points(rng, L):
    return np.stack(
        [rng.uniform(-1, 1, L), rng.uniform(-0.7, 0.7, L), rng.uniform(2, 4, L)], 1
    ).astype(np.float32)


def _basic(rng):
    L = N = 64
    X = _points(rng, L)
    uv = np.array(jcam.project(jax_tum3().camera, jnp.asarray(X)))
    desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    return dict(X=X, desc=desc, valid=np.ones(L, bool), oct=np.zeros(L, np.int32),
                uv=uv, kdesc=desc, koct=np.zeros(N, np.int32), kvalid=np.ones(N, bool),
                T=np.eye(4, dtype=np.float32)), {}


def _view_cos(rng):
    args, _ = _basic(rng)
    X = args["X"]
    view = X / np.linalg.norm(X, axis=1, keepdims=True)
    normal = view.copy()
    normal[0] = -view[0]
    normal[1] = 0.0
    axis = np.array([view[2][1], -view[2][0], 0.0])
    axis /= np.linalg.norm(axis) + 1e-9
    R70 = np.asarray(jse3.exp_so3(jnp.asarray((axis * np.deg2rad(70)).astype(np.float32))))
    normal[2] = R70 @ view[2]
    return args, dict(map_normal=normal.astype(np.float32))


def _conflict(rng):
    X = np.array([[0.0, 0.0, 3.0], [0.0, 0.0, 3.0]], np.float32)
    uv = np.array(jcam.project(jax_tum3().camera, jnp.asarray(X)))[:1]
    kdesc = rng.integers(0, 2**32, (1, 8), dtype=np.uint32)
    desc = np.stack([kdesc[0] ^ np.uint32(0b111), kdesc[0]])
    return dict(X=X, desc=desc, valid=np.ones(2, bool), oct=np.zeros(2, np.int32),
                uv=uv, kdesc=kdesc, koct=np.zeros(1, np.int32), kvalid=np.ones(1, bool),
                T=np.eye(4, dtype=np.float32)), {}


def _cluttered(rng):
    """256 landmarks, 200 keypoints: projection noise, octave spread,
    near-duplicate landmarks competing for one keypoint, descriptor noise,
    a dominant rotation plus outlier rotations, invalid rows, a pose."""
    L, N = 256, 200
    X = _points(rng, L)
    X[200:230] = X[:30] + rng.normal(0, 0.002, (30, 3)).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.01], np.float32))))
    Xc = np.asarray(jse3.transform(jnp.asarray(T), jnp.asarray(X[:N])))
    uv = np.array(jcam.project(jax_tum3().camera, jnp.asarray(Xc))) + rng.normal(0, 3, (N, 2)).astype(np.float32)
    desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    desc[200:230] = desc[:30]
    kdesc = desc[:N].copy()
    flips = rng.integers(0, 2**32, (N, 8), dtype=np.uint32) & rng.integers(0, 2**32, (N, 8), dtype=np.uint32) \
        & rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    kdesc ^= np.where(rng.uniform(size=(N, 1)) < 0.3, flips, np.uint32(0))
    valid = rng.uniform(size=L) < 0.95
    oct_ = rng.integers(0, 4, L).astype(np.int32)
    koct = np.clip(oct_[:N] + rng.integers(-1, 2, N), 0, 7).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, L).astype(np.float32)
    kangle = angle[:N] + np.where(rng.uniform(size=N) < 0.8, 0.25, rng.uniform(-3, 3, N)).astype(np.float32)
    normal = np.zeros((L, 3), np.float32)
    normal[::3] = X[::3] / np.linalg.norm(X[::3], axis=1, keepdims=True)
    return dict(X=X, desc=desc, valid=valid, oct=oct_, uv=uv, kdesc=kdesc, koct=koct,
                kvalid=rng.uniform(size=N) < 0.97, T=T.astype(np.float32)), \
        dict(map_angle=angle, kp_angle=kangle.astype(np.float32), map_normal=normal)


FIXTURES = {"basic": _basic, "view_cos": _view_cos, "conflict": _conflict, "cluttered": _cluttered}


def _run_both(a, opt, **kw):
    L = len(a["X"])
    jres = jmatch.search_by_projection(
        jnp.asarray(a["X"]), jnp.asarray(a["desc"]), jnp.asarray(a["valid"]),
        jnp.arange(L, dtype=jnp.int32), jnp.asarray(a["oct"]),
        jnp.asarray(a["uv"]), jnp.asarray(a["kdesc"]), jnp.asarray(a["koct"]),
        jnp.asarray(a["kvalid"]), jnp.asarray(a["T"]), jax_tum3().camera,
        **{k: jnp.asarray(v) for k, v in opt.items()}, **kw,
    )
    tres = tmatch.search_by_projection(
        t(a["X"]), t(a["desc"].astype(np.int64)), t(a["valid"]),
        t(np.arange(L)), t(a["oct"].astype(np.int64)),
        t(a["uv"]), t(a["kdesc"].astype(np.int64)), t(a["koct"].astype(np.int64)),
        t(a["kvalid"]), t(a["T"]), tum3_config().camera,
        **{k: t(v) for k, v in opt.items()}, **kw,
    )
    return jres, tres


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_search_by_projection_parity(fixture):
    a, opt = FIXTURES[fixture](np.random.default_rng(0))
    jres, tres = _run_both(a, opt)
    np.testing.assert_array_equal(tres.pt_id_per_kp.numpy(), np.asarray(jres.pt_id_per_kp))
    np.testing.assert_array_equal(tres.visible.numpy(), np.asarray(jres.visible))
    assert int(tres.n_matches) == int(jres.n_matches) > 0


def test_search_wide_window_variant():
    """The wide-window retry's variant (radius 50, no octave check)."""
    a, opt = _cluttered(np.random.default_rng(1))
    jres, tres = _run_both(a, opt, radius=50.0, check_octave=False)
    np.testing.assert_array_equal(tres.pt_id_per_kp.numpy(), np.asarray(jres.pt_id_per_kp))
