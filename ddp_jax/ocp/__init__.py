from ddp_jax.ocp import constraints, costs, dynamics, problem

__all__ = ["constraints", "costs", "dynamics", "problem"]
