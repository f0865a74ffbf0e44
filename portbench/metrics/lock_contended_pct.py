"""% of the traced requests that found the service's render lock held
(``serve.lock_contended`` over the ``serve.request`` spans)."""
from portbench import spans


def read(prof):
    records, counts = spans.program_spans(), spans.program_counters()
    n = len(spans.requests(records or []))
    if not n or counts is None:
        return None
    return 100.0 * counts.get("serve.lock_contended", 0) / n
