from ddp_jax.solver import al, riccati, rollout, solve

__all__ = ["al", "riccati", "rollout", "solve"]
