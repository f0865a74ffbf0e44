"""% of the traced requests' time (their ``serve.request`` spans) spent
waiting for the service's render lock (``serve.lock_wait``), from the
program's records in memory: the handler threads are not in the trace."""
from portbench import spans


def read(prof):
    return spans.request_share("serve.lock_wait")
