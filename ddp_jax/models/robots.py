"""Built-in robot constructors (the model zoo the reference drives via
Pinocchio + external URDFs)."""

from __future__ import annotations

import os

import jax.numpy as jnp

from ddp_jax.models.rigid_body import (
    RobotModel,
    all_joints_test_model,
    build_model,
    double_pendulum,
)
from ddp_jax.models.urdf import load_urdf

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def ur5(dtype=jnp.float64) -> RobotModel:
    """6-DoF UR5 arm from the bundled URDF (≙ test/pinocchio_ddp.cpp:30)."""
    return load_urdf(os.path.join(_ASSETS, "ur5.urdf"), dtype=dtype)


def panda7(dtype=jnp.float64) -> RobotModel:
    """7-DoF Panda-class arm (BASELINE configs[3]: "equality-constrained DDP
    on a 7-DoF arm").  Kinematic layout follows the Franka Panda joint
    arrangement (alternating z/y axes with elbow offsets); inertial values
    are representative link masses/inertias."""
    import numpy as np

    d1, d3, d5, a4, a7 = 0.333, 0.316, 0.384, 0.0825, 0.107
    joints = [
        dict(type="revolute", parent=-1, placement_trans=[0, 0, d1], axis=[0, 0, 1],
             mass=3.5, com=[0, -0.03, -0.08], inertia=np.diag([0.02, 0.02, 0.008])),
        dict(type="revolute", parent=0, axis=[0, 1, 0],
             mass=3.5, com=[0, -0.07, 0.03], inertia=np.diag([0.02, 0.018, 0.008])),
        dict(type="revolute", parent=1, placement_trans=[0, 0, d3], axis=[0, 0, 1],
             mass=2.5, com=[0.04, 0.02, -0.05], inertia=np.diag([0.01, 0.01, 0.006])),
        dict(type="revolute", parent=2, placement_trans=[a4, 0, 0], axis=[0, -1, 0],
             mass=2.5, com=[-0.04, 0.05, 0.02], inertia=np.diag([0.01, 0.009, 0.006])),
        dict(type="revolute", parent=3, placement_trans=[-a4, 0, d5], axis=[0, 0, 1],
             mass=1.8, com=[0, 0.03, -0.1], inertia=np.diag([0.008, 0.008, 0.004])),
        dict(type="revolute", parent=4, axis=[0, -1, 0],
             mass=1.5, com=[0.06, -0.02, 0.01], inertia=np.diag([0.004, 0.004, 0.002])),
        dict(type="revolute", parent=5, placement_trans=[0.088, 0, 0], axis=[0, 0, -1],
             mass=0.8, com=[0, 0, 0.06], inertia=np.diag([0.002, 0.002, 0.001])),
    ]  # fmt: skip
    frames = [dict(name="ee", body=6, trans=[0.0, 0.0, a7])]
    return build_model(joints, frames=frames, name="panda7", dtype=dtype)


def cartpole(dtype=jnp.float64) -> RobotModel:
    """Prismatic cart + revolute pole (classic underactuated benchmark)."""
    import numpy as np

    joints = [
        dict(type="prismatic", parent=-1, axis=[1, 0, 0],
             mass=1.0, com=[0, 0, 0], inertia=np.diag([1e-4, 1e-4, 1e-4])),
        dict(type="revolute", parent=0, axis=[0, 1, 0],
             mass=0.3, com=[0.0, 0.0, 0.5], inertia=np.diag([1e-4, 1e-4, 1e-5])),
    ]  # fmt: skip
    frames = [dict(name="tip", body=1, trans=[0.0, 0.0, 1.0])]
    return build_model(joints, frames=frames, name="cartpole", dtype=dtype)


def acrobot(dtype=jnp.float64) -> RobotModel:
    """Double pendulum actuated only at the elbow (set damping/torque
    masking at the problem layer; the model itself is the double pendulum
    with standard acrobot inertias)."""
    import numpy as np

    joints = [
        dict(type="revolute", parent=-1, axis=[0, 1, 0],
             mass=1.0, com=[0, 0, -0.5], inertia=np.diag([0.083, 0.083, 1e-4])),
        dict(type="revolute", parent=0, placement_trans=[0, 0, -1.0], axis=[0, 1, 0],
             mass=1.0, com=[0, 0, -0.5], inertia=np.diag([0.083, 0.083, 1e-4])),
    ]  # fmt: skip
    frames = [dict(name="tip", body=1, trans=[0.0, 0.0, -1.0])]
    return build_model(joints, frames=frames, name="acrobot", dtype=dtype)


def quadrotor(dtype=jnp.float64) -> RobotModel:
    """Free-flying rigid body (quadrotor-class): one freeflyer joint; the
    control map (rotor forces → wrench) lives at the problem layer."""
    import numpy as np

    joints = [
        dict(type="freeflyer", parent=-1,
             mass=1.0, com=[0, 0, 0], inertia=np.diag([0.01, 0.01, 0.02])),
    ]  # fmt: skip
    frames = [dict(name="base", body=0, trans=[0.0, 0.0, 0.0])]
    return build_model(joints, frames=frames, name="quadrotor", dtype=dtype)


def ee_frame_id(model: RobotModel, name: str = "ee_link") -> int:
    return model.frame_names.index(name)


__all__ = [
    "all_joints_test_model",
    "build_model",
    "double_pendulum",
    "ur5",
    "panda7",
    "cartpole",
    "acrobot",
    "quadrotor",
    "ee_frame_id",
    "load_urdf",
]
