"""% of the traced window's device-idle time during which the host was
innermost in ``rays.sample`` (coarse samples with ESS's probe; the fine
samples, merged and sorted)."""
from portbench import spans


def read(prof):
    return spans.idle_share(prof, ("rays.sample",))
