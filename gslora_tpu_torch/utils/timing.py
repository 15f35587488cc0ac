"""Device timing of work on the card with CUDA events (used by
``chip_smoke.py`` and ``gslora_tpu_torch.tools.group_bench``)."""
from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` on the current stream.

    The timed calls queue behind a device-side sleep, so the host has
    enqueued all of them before the first starts, and the events time the
    device's work back to back rather than the host's dispatch (which for
    a library call can take longer than its kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 25  # ~17 ms at the H100's boost clock
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
        cycles *= 4
    else:
        print("timing: the device woke before the host had queued every "
              "call; this time includes host dispatch", flush=True)
    return start.elapsed_time(end) / iters


def cuda_cold_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn`` with a cold L2: before each call a
    64 MB write (more than the H100's 50 MB L2) evicts its inputs, and each
    call is timed by its own pair of events, so the flush is not counted.
    As in :func:`cuda_ms`, everything queues behind a device-side sleep."""
    flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(1 << 25)
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters
