"""The FLOPs a DiT step requires (portbench.flops) over the profiler window's time at the bf16 peak, %."""


def read(t):
    return t.mfu()
