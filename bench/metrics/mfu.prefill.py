"""The whole step's share of the card's bf16 peak over the window: the
operations every token of the window needs (``counts``: each prompt whose
first token came in the window, each decoded token) over the window's
seconds times 989 TFLOP/s.  Host clock and the benchmark's own counts."""
import counts

SOURCE = "host_clock"


def read(run):
    flops = run.window_flops()
    if flops <= 0:
        return None
    return 100.0 * flops / (run.window_s * counts.PEAK_BF16_FLOPS)
