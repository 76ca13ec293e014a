"""Host milliseconds an engine step outside its fenced calls, over the
window: (window wall - the engine's prefill_s - decode_s) / steps."""

SOURCE = "program_counter"


def read(run):
    steps = run.delta("steps")
    if steps <= 0:
        return None
    host = run.window_s - run.delta("prefill_s") - run.delta("decode_s")
    return 1e3 * host / steps
