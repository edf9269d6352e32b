"""The sphere tolerance of `test_torch_adversarial.py::
test_render_quads_and_spheres_match_jax` over every orbit frame of both
adversarial scenes, against the float64 render of the same formulas.

Prints the largest ratio of each depth difference (port - JAX, port -
float64, JAX - float64) to 1e-5 m + eps z / sqrt(disc / B^2), and the
largest gray difference between each package and the float64 shade at its
own depth. The test itself checks three of these frames, with the bound
doubled.

    JAX_PLATFORMS=cpu python tests/sphere_rounding_sweep.py
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hfvo_tpu.testing import synthetic as jsyn  # noqa: E402
from hfvo_tpu_torch.testing import synthetic as tsyn  # noqa: E402
from hfvo_tpu_torch.testing.adversarial import SCENES  # noqa: E402
from test_torch_adversarial import _spheres_f64  # noqa: E402
from torch_helpers import small_intrinsics  # noqa: E402


def main(n_frames: int = 25) -> dict:
    intr, eps = small_intrinsics(), np.finfo(np.float32).eps
    worst = dict.fromkeys(("port-jax", "port-f64", "jax-f64", "gray port", "gray jax"), 0.0)
    none = torch.zeros((0, 3))
    for name in ("slanted", "low_texture_slanted"):
        jscene, scene = jsyn.make_adversarial_room(**SCENES[name]), tsyn.make_adversarial_room(**SCENES[name])
        for T_wc in tsyn.orbit_trajectory(n_frames):
            jg, jd = (np.asarray(a) for a in jsyn.render_jit(jscene, intr, jnp.asarray(T_wc)))
            tg, td = (a.numpy() for a in tsyn.render(scene, intr, torch.from_numpy(T_wc)))
            walls = tsyn.render(scene._replace(quad_c=none, sphere_c=none, sphere_r=none[:, 0]), intr,
                                torch.from_numpy(T_wc))[1].numpy()
            no_quads = tsyn.render(scene._replace(quad_c=none), intr, torch.from_numpy(T_wc))[1].numpy()
            ball = (td != walls) & (td == no_quads)
            z64, _, cond = _spheres_f64(scene, intr, T_wc)
            env = 1e-5 + eps * z64[ball] / np.sqrt(cond[ball])
            seen = {
                "port-jax": np.abs(td - jd)[ball] / env,
                "port-f64": np.abs(td - z64)[ball] / env,
                "jax-f64": np.abs(jd - z64)[ball] / env,
                "gray port": np.abs(tg - _spheres_f64(scene, intr, T_wc, td.astype(np.float64))[1])[ball],
                "gray jax": np.abs(jg - _spheres_f64(scene, intr, T_wc, jd.astype(np.float64))[1])[ball],
            }
            for k, v in seen.items():
                if v.size:
                    worst[k] = max(worst[k], float(v.max()))
    return worst


if __name__ == "__main__":
    print(main())
