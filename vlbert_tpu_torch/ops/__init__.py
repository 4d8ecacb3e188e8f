"""Ops of the port: each kernel wrapper beside its plain PyTorch version."""

import torch

# the element types the kernels take, by the code their C entry points
# read (csrc/common.cuh DtypeCode)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def device_kind(t):
    """The device type a wrapper dispatches on: "cpu" takes the plain
    version, "cuda" launches the kernel, anything else is refused."""
    return t.device.type
