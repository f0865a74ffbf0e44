"""% of the traced requests' time (their ``serve.request`` spans) spent
encoding the PNG (``serve.png``), from the program's records in memory."""
from portbench import spans


def read(prof):
    return spans.request_share("serve.png")
