"""The FLOPs a G step requires (portbench.flops) over the profiler window's time at the bf16 peak, %."""


def read(t):
    return t.mfu()
