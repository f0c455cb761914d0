from ddp_jax.models import base, pendulum

__all__ = ["base", "pendulum"]
