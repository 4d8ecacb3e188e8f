"""launches_per_step: the CUDA kernels the profiled steps launched (not
copies or fills), over the steps."""

from portbench import trace


def read(ctx):
    steps = len(ctx["timing"]["profiled"])
    kernels = sum(1 for name, _, _ in ctx["traced"]["device"]
                  if trace.is_kernel(name))
    return kernels / steps if steps and kernels else None
