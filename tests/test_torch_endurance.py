"""The endurance protocols of tests/test_endurance.py on the port, on the
CPU (`hfvo_tpu_torch.testing.endurance`): 320 frames of points-only
tracking past a 24-slot keyframe table (>= 97 % OK, <= 24 live keyframes,
more than 24 insertions, ATE < 0.25 m) and 300 frames of the complete
default system with the sensor model (0 LOST, ATE <= 0.05 m, each
100-frame window <= 0.04 m, 8-64 keyframes inserted), with the JAX suite's
gates. Marked slow: at 1-3 s a frame on the CPU they take far longer than
the tier-1 run allows; chip_smoke.py's `endurance` phase runs both on the
card."""
import pytest

from hfvo_tpu_torch.testing import endurance


@pytest.mark.slow
def test_endurance_past_kf_capacity():
    r = endurance.points_past_kf_capacity("cpu")
    assert endurance.points_past_kf_capacity_ok(r), r


@pytest.mark.slow
def test_endurance_full_stack_300():
    r = endurance.full_stack_300("cpu")
    assert endurance.full_stack_300_ok(r), r
