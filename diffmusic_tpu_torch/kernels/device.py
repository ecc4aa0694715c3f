"""Which version a kernel wrapper runs, from the device of its input."""


def use_plain(x, name: str) -> bool:
    """True for a CPU tensor (the plain PyTorch version runs), False for a CUDA
    tensor (the kernel launches, or the wrapper raises); any other device
    raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {x.device}")
