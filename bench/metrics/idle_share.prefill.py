"""Share of the traced slice's wall in which no operation ran on the
card: one minus the union of the device intervals ``torch.profiler``
recorded (CUDA activity) over the slice's wall."""

SOURCE = "device_trace"


def read(run):
    sl = run.slice
    if sl is None or sl.n == 0 or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
