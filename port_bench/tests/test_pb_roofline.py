"""The frozen roofline table against hand counts at 32 x 64."""

import pytest

from port_bench import roofline

PLANE8 = 32 * 64 * 8          # one (NR, NAZ) float64 grid
VPLANE8 = 33 * 64 * 8         # one (NR + 1, NAZ) float64 grid
COLS8 = 33 * 24 * 8           # the kernels' geometry columns


@pytest.mark.parametrize("op, expected", [
    # sigma, energy, v_az, Q+, Q-, v_rad in
    ("cfl", 5 * PLANE8 + VPLANE8 + COLS8),
    # sigma, energy, v_az, v_rad in; v_az, v_rad out
    ("sources", 4 * PLANE8 + 2 * VPLANE8 + COLS8),
    # + v_az, energy, Q+, Q-, v_rad out
    ("viscous_kick", 7 * PLANE8 + 2 * VPLANE8 + COLS8),
    # + sigma, energy, v_az, v_rad and the mass flux out
    ("transport", 6 * PLANE8 + 3 * VPLANE8 + COLS8),
    # + energy, v_az, v_rad out
    ("artvisc_sn", 5 * PLANE8 + 2 * VPLANE8 + COLS8),
])
def test_bytes_hand_counts(op, expected):
    assert roofline.op_bytes(op, 32, 64, 8) == expected
    assert roofline.op_bytes(op, 32, 64, 4) == expected // 2


def test_transport_least_time_at_full_size():
    # 1024 x 3072 float64: 6 planes, 3 v-planes and the columns at 3.35 TB/s
    b = (6 * 1024 + 3 * 1025) * 3072 * 8 + 1025 * 24 * 8
    assert roofline.least_s("transport", 1024, 3072, 8) == \
        pytest.approx(b / 3.35e12, rel=1e-12)


def test_frozen_operation_counts():
    counted = roofline.count_flops_per_cell()
    assert counted == pytest.approx(roofline.FLOPS_PER_CELL, rel=1e-3)
