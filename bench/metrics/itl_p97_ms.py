"""Gap between consecutive tokens of one request, 97th percentile over
every gap of every request in the window, stamped when ``step()``
returns; a step that carried a prefill grant counts in full, and a
request still owing tokens at the close adds its wait since its last
token.  Where about one step in sixteen carries a grant of a long prompt's
chunk, the gaps above the 94th percentile are those steps; the 97th lies
in the middle of them, the 95th at their lower edge.  Host clock."""
import stats

SOURCE = "host_clock"


def read(run):
    p = stats.percentile(stats.window_gaps(run), 97)
    return None if p is None else 1e3 * p
