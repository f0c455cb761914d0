"""URDF loader tests: the bundled UR5, limits and mimic records, and
model-construction semantics (fixed-joint merging, frames, floating base)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from ddp_jax.models.robots import ur5
from ddp_jax.models.urdf import load_urdf

MINI_URDF = """
<robot name="mini">
  <link name="world"/>
  <joint name="j1" type="revolute">
    <parent link="world"/><child link="l1"/>
    <origin xyz="0 0 0.5" rpy="0 0 0"/><axis xyz="0 1 0"/>
  </joint>
  <link name="l1">
    <inertial>
      <mass value="2.0"/><origin xyz="0 0 -0.4"/>
      <inertia ixx="0.03" iyy="0.03" izz="0.001"/>
    </inertial>
  </link>
  <joint name="jf" type="fixed">
    <parent link="l1"/><child link="tool"/>
    <origin xyz="0 0 -0.8" rpy="0 0 0"/>
  </joint>
  <link name="tool">
    <inertial><mass value="0.5"/><origin xyz="0 0 0"/>
      <inertia ixx="1e-4" iyy="1e-4" izz="1e-4"/></inertial>
  </link>
</robot>
"""


UR5_URDF = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "ddp_jax", "models", "assets", "ur5.urdf"
)


def test_ur5_urdf_model():
    """The bundled UR5 loads as a 6-joint serial chain with the URDF's
    limits, the fixed end-effector link folded into a frame, and the
    links' total mass on the bodies; path and XML-string inputs agree."""
    m = load_urdf(UR5_URDF)
    assert tuple(m.joint_types) == ("revolute",) * 6
    assert list(m.parents) == [-1, 0, 1, 2, 3, 4]
    assert "ee_link" in m.frame_names
    two_pi, pi = 6.2831853, 3.14159265
    np.testing.assert_allclose(np.asarray(m.q_upper), [two_pi, two_pi, pi, two_pi, two_pi, two_pi])
    np.testing.assert_allclose(np.asarray(m.q_lower), -np.asarray(m.q_upper))
    np.testing.assert_allclose(np.asarray(m.v_limit), [3.15] * 3 + [3.2] * 3)
    np.testing.assert_allclose(np.asarray(m.tau_limit), [150.0] * 3 + [28.0] * 3)
    # every link's mass but the fixed base's lands on a body (the ee link
    # folds into wrist_3): 3.7 + 8.393 + 2.275 + 1.219 + 1.219 + 0.1879 + 0.01
    np.testing.assert_allclose(float(np.asarray(m.inertias)[:, 5, 5].sum()), 17.0039, rtol=1e-12)
    with open(UR5_URDF) as f:
        m_str = load_urdf(f.read())
    np.testing.assert_array_equal(np.asarray(m.inertias), np.asarray(m_str.inertias))
    M = np.asarray(m.mass_matrix(m.neutral_configuration()))
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    assert np.all(np.linalg.eigvalsh(M) > 0)


def test_mimic_multiplier_and_offset():
    """<mimic multiplier= offset=> reaches the reduced model: the slaved
    coordinate is c·q_master + o, and its velocity c·v_master."""
    g = load_urdf(
        GRIPPER_URDF.replace('multiplier="1.0" offset="0.0"', 'multiplier="-0.5" offset="0.01"')
    )
    np.testing.assert_allclose(np.asarray(g.coupling), [[1, 0], [0, 1], [0, -0.5]])
    qf = np.asarray(g.q_full(jnp.asarray([0.3, 0.02])))
    np.testing.assert_allclose(qf, [0.3, 0.02, -0.5 * 0.02 + 0.01], atol=1e-15)
    vf = np.asarray(g.v_full(jnp.asarray([0.5, -0.1])))
    np.testing.assert_allclose(vf, [0.5, -0.1, 0.05], atol=1e-15)


def test_fixed_joint_merges_inertia_and_adds_frame():
    m = load_urdf(MINI_URDF)
    assert m.nb == 1
    assert "tool" in m.frame_names
    # merged mass = 2.0 + 0.5 at the m[5,5] block of the spatial inertia
    mass = float(m.inertias[0, 5, 5])
    assert abs(mass - 2.5) < 1e-12
    # tool frame sits 0.8 below the joint, joint 0.5 above world
    fid = m.frame_names.index("tool")
    p = m.frame_position(fid, m.neutral_configuration())
    np.testing.assert_allclose(np.asarray(p), [0.0, 0.0, -0.3], atol=1e-12)


def test_floating_base_insertion():
    m = load_urdf(MINI_URDF, root_joint="freeflyer")
    assert m.joint_types[0] == "freeflyer"
    assert m.nq == 7 + 1 and m.nv == 6 + 1
    # world link's (empty) inertia lands on the floating base; dynamics with
    # a zero-inertia base would be singular, so give it the merged chain —
    # the base body has zero inertia here but children attach below it
    q = m.neutral_configuration()
    assert np.isfinite(np.asarray(m.mass_matrix(q))).all()


def test_pendulum_urdf_matches_closed_form():
    """The mini URDF is a gravity pendulum: point mass 2 kg at 0.4 m; its
    dynamics must match a = (τ + m·g·l·sin... ) from first principles."""
    m = load_urdf(MINI_URDF)
    q = jnp.asarray([0.3])
    v = jnp.asarray([0.0])
    tau = jnp.asarray([0.0])
    a = float(m.forward_dynamics(q, v, tau)[0])
    # l1 inertia: m=2 at com z=-0.4 (I_com given) + tool 0.5 kg at z=-0.8
    # pendulum about y-axis: I_total = Σ(I_com + m d²), torque = Σ m g d sin(q)
    I_tot = 0.03 + 2.0 * 0.4**2 + 1e-4 + 0.5 * 0.8**2
    torque_g = -(2.0 * 9.81 * 0.4 + 0.5 * 9.81 * 0.8) * np.sin(0.3)
    np.testing.assert_allclose(a, torque_g / I_tot, rtol=1e-10)


GRIPPER_URDF = """
<robot name="gripper">
  <link name="base">
    <inertial><mass value="1.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01"/></inertial>
  </link>
  <joint name="lift" type="revolute">
    <parent link="base"/><child link="palm"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-1.0" upper="1.5" velocity="2.0" effort="30.0"/>
  </joint>
  <link name="palm">
    <inertial><mass value="0.5"/><origin xyz="0 0 0.05"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.001"/></inertial>
  </link>
  <joint name="finger_l" type="prismatic">
    <parent link="palm"/><child link="tip_l"/>
    <origin xyz="0.02 0 0.1"/><axis xyz="1 0 0"/>
    <limit lower="0.0" upper="0.04" velocity="0.2" effort="10.0"/>
  </joint>
  <link name="tip_l">
    <inertial><mass value="0.1"/><origin xyz="0 0 0.01"/>
      <inertia ixx="1e-4" iyy="1e-4" izz="1e-4"/></inertial>
  </link>
  <joint name="finger_r" type="prismatic">
    <parent link="palm"/><child link="tip_r"/>
    <origin xyz="-0.02 0 0.1"/><axis xyz="-1 0 0"/>
    <mimic joint="finger_l" multiplier="1.0" offset="0.0"/>
    <limit lower="0.0" upper="0.04" velocity="0.2" effort="10.0"/>
  </joint>
  <link name="tip_r">
    <inertial><mass value="0.1"/><origin xyz="0 0 0.01"/>
      <inertia ixx="1e-4" iyy="1e-4" izz="1e-4"/></inertial>
  </link>
</robot>
"""


def test_joint_limits_parsed():
    """<limit> elements populate the model's limit arrays in the q/v layout
    (≙ pinocchio::model_t position/velocity/effort limits via urdfdom)."""
    m = load_urdf(MINI_URDF)
    # MINI_URDF declares no limits → unbounded
    assert np.isinf(np.asarray(m.q_lower)).all()
    assert np.isinf(np.asarray(m.tau_limit)).all()

    g = load_urdf(GRIPPER_URDF)
    # reduced model: masters are (lift, finger_l)
    np.testing.assert_allclose(np.asarray(g.q_lower), [-1.0, 0.0])
    np.testing.assert_allclose(np.asarray(g.q_upper), [1.5, 0.04])
    np.testing.assert_allclose(np.asarray(g.v_limit), [2.0, 0.2])
    np.testing.assert_allclose(np.asarray(g.tau_limit), [30.0, 10.0])


def test_mimic_reduction_dynamics():
    """A mimic joint reduces the model (urdfdom JointMimic): the slaved
    finger is eliminated, and the reduced dynamics equal the projected full
    dynamics M_red = C^T M C, tau_red = C^T tau (gear reduction)."""
    from ddp_jax.models.reduced import ReducedModel

    g = load_urdf(GRIPPER_URDF)
    assert isinstance(g, ReducedModel)
    assert g.nq == g.nv == 2
    assert g.full.nv == 3

    C = np.asarray(g.coupling)
    # masters identity rows + slaved row tied to finger_l with multiplier 1
    np.testing.assert_allclose(C, [[1, 0], [0, 1], [0, 1]])

    q = jnp.asarray([0.3, 0.02])
    v = jnp.asarray([0.5, -0.1])
    tau = jnp.asarray([1.0, 0.4])

    M_red = np.asarray(g.mass_matrix(q))
    M_full = np.asarray(g.full.mass_matrix(g.q_full(q)))
    np.testing.assert_allclose(M_red, C.T @ M_full @ C, atol=1e-12)
    assert np.all(np.linalg.eigvalsh(0.5 * (M_red + M_red.T)) > 0)

    # FD/ID round trip in reduced coordinates
    a = g.forward_dynamics(q, v, tau)
    np.testing.assert_allclose(np.asarray(g.rnea(q, v, a)), np.asarray(tau), atol=1e-9)

    # the slaved coordinate tracks the master exactly in the full map
    qf = np.asarray(g.q_full(q))
    assert qf[2] == qf[1]


def test_mimic_reduced_model_solves():
    """End-to-end: DDP solve on the reduced gripper (ConfigTarget reach)."""
    import jax

    from ddp_jax.models import base
    from ddp_jax.ocp import constraints, costs, dynamics
    from ddp_jax.ocp.problem import Problem
    from ddp_jax.solver.solve import SolverParams, solve

    g = load_urdf(GRIPPER_URDF)
    H = 20
    dyn = dynamics.euler(g, 0.01)
    target = jnp.asarray([0.2, 0.03])
    con = constraints.advance_time(
        constraints.ConfigTarget(model=g, target=target, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=30, threshold=1e-8, mu=1e6)
    x0 = base.state_pack(g.neutral_configuration(), jnp.zeros(2, jnp.float64))
    res = jax.jit(lambda x: solve(problem, params, x))(x0)
    assert float(res.stats.opt_constr) < 1e-6
    qT = np.asarray(res.xs[-1, :2])
    np.testing.assert_allclose(qT, np.asarray(target), atol=1e-5)
