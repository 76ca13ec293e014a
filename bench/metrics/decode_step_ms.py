"""Fenced milliseconds a decode call over the window: the engine's
``decode_s / decode_calls``."""

SOURCE = "program_counter"


def read(run):
    calls = run.delta("decode_calls")
    if calls <= 0:
        return None
    return 1e3 * run.delta("decode_s") / calls
