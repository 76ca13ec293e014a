"""The whole step's share of the card's bf16 peak over the window, for an
afmoe configuration: the operations every token of the window needs
(``counts_afmoe``: each prompt whose first token came in the window, whole,
with windowed attention on the sliding layers and the k routed experts and
the shared one on the MoE layers; each decoded token of the window) over
the window's seconds times 989 TFLOP/s.  Host clock and the benchmark's own
counts.  Nothing is read where the configuration is not afmoe."""
import counts_afmoe

SOURCE = "host_clock"


def read(run):
    if run.cell.cfg.get("family") != "afmoe":
        return None
    s, flops = counts_afmoe.Sizes(run.cell.cfg), 0.0
    for r in run.requests:
        if run.in_window(r.first):
            flops += counts_afmoe.prompt_flops(s, len(r.prompt))
        for j in range(1, len(r.stamps)):
            if run.in_window(r.stamps[j]):
                flops += counts_afmoe.decode_flops(s, len(r.prompt) + j - 1)
    if flops <= 0:
        return None
    return 100.0 * flops / (run.window_s * counts_afmoe.PEAK_BF16_FLOPS)
