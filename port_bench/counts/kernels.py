"""Operations and bytes of the port's two physics kernels, counted from
their sources and shapes (copied from the port's chip_smoke.py): kernel A
(`csrc/fk.cu`, FK and sphere positions) and kernel B (`csrc/dynamics.cu`,
one dynamics substep). Bytes are the rows a launch reads and writes, each
once, float32; the robot's constant buffer, shared by every env, is left
out. Kernel B's operations are counted with no touching sphere (the count
that a contact adds, ~240, depends on the state), so its operation bound
is a lower bound and the roofline takes the larger of the two bounds."""
from __future__ import annotations

from ..peaks import FLOPS, HBM_BYTES_PER_S


def fk_flops(nb: int, nj: int, P: int) -> int:
    """Per env: per joint two quaternion rotations (30 each), two Hamilton
    products (28 each), sin/cos and the anchor (8); per body a rotation
    matrix (30); per sphere a 3x3 product and add (18)."""
    return nj * (2 * 30 + 2 * 28 + 8) + nb * 30 + P * 18


def fk_bytes(nb: int, nj: int, P: int) -> int:
    """Per env: in (7 + nj) state rows; out nb*7 + nj*6 body rows and 3 P
    sphere positions."""
    return 4 * ((7 + nj) + (nb * 7 + nj * 6) + 3 * P)


def dynamics_flops(nb: int, nj: int, nv: int, P: int, anc,
                   ceiling: bool, touching: float = 0.0) -> float:
    """Per env: per body its pose, rotation and inertia (~180), bias force
    and momentum (~117), new velocity (12) and subtree sums (52 a non-root
    body); per joint its axis (9), velocity and acceleration (45) and
    composite and contact axis forces (~100); per dof its rhs row (~40);
    per nonzero lower entry of the system ~25; the factorization (3 per
    ancestor pair of each dof, ~150 for the base block) and the forward
    solve (2 per ancestor); ground geometry in both contact passes (~70 a
    sphere; the ceiling's depth 3); integration and feet (~250); and ~240
    per touching sphere. `anc[b]` is body b's ancestor-or-self dof mask."""
    n_anc = [int(sum(1 for x in row if x > 0.5)) for row in anc]
    nnz = 21 + sum(n_anc[1:])
    pairs = sum(3 * (n - 1) * n // 2 for n in n_anc[1:])
    fixed = (nb * (180 + 117 + 12) + 52 * (nb - 1) + nj * (9 + 45 + 100)
             + 40 * nv + 25 * nnz + pairs + 150 + 2 * sum(n_anc[1:])
             + 2 * (70 * P + (3 * P if ceiling else 0)) + 250)
    return fixed + 240 * touching


def dynamics_bytes(nb: int, nj: int, nv: int, P: int, ceiling: bool) -> int:
    """Per env: in the state and torques (7 + nj + nv + nj), the FK rows
    (nb*7 + nj*6), sphere positions 3 P, corner heights 4 P, cell offsets
    2 P, env coefficients 9 and with a ceiling its heights P; out the 13
    output groups (59 + 2 nj rows)."""
    rows_in = ((7 + nj + nv + nj) + (nb * 7 + nj * 6) + 9 * P + 9
               + (P if ceiling else 0))
    return 4 * (rows_in + 59 + 2 * nj)


def least_seconds(n_bytes: float, n_flops: float) -> float:
    """The larger of bytes over HBM bandwidth and fp32 operations over the
    fp32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FLOPS["float32"])


def robot_dims(name: str):
    """(nb, nj, nv, P, anc) of a robot, from the benchmark's frozen copy
    of the port's robot data."""
    from ..reference.frozen.models import load_robot
    m = load_robot(name)
    return (m.nb, m.nj, m.nv, m.P,
            [list(map(float, row)) for row in m.static["anc"]])
