"""A counter of the torch operations the step dispatches (each a launch or
a few on the card, none for a view), over a stretch of steps: a
`TorchDispatchMode` that counts and passes every call on, as
swarm_tpu_torch/profile_step.py's `step_launches` counts them. Runs on any
device.

Record: {"steps": n, "ops": count}."""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def run(ctx, state, metrics):
    count = _Count()
    n = ctx.steps("dispatch")
    with count:
        for _ in range(n):
            state, _ = ctx.program.step(state)
    return state, {"steps": n, "ops": count.n}
