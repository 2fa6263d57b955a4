from swarm_tpu_torch.server.live import LiveServer  # noqa: F401
