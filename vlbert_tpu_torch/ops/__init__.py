"""Ops of the port: each kernel wrapper beside its plain PyTorch version."""


def device_kind(t):
    """The device type a wrapper dispatches on: "cpu" takes the plain
    version, "cuda" launches the kernel, anything else is refused."""
    return t.device.type
