"""Time to first token, 90th percentile over every request sent in the
window, from when its client sent it to the step that returned its first
token; a request still waiting at the close counts with its wait so far.
Host clock.

In rag-prefill the waits form a staircase by prompt size (one grant step,
two, the two 4,096-token grants of the longest prompts); the 90th lies
inside the top step, which holds 14-16 % of the requests, while the
80th-85th fall on the risers and swing by half from seed to seed."""
import stats

SOURCE = "host_clock"


def read(run):
    p = stats.percentile(stats.window_ttfts(run), 90)
    return None if p is None else 1e3 * p
