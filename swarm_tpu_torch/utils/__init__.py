from swarm_tpu_torch.utils.angles import wrap_pi  # noqa: F401
