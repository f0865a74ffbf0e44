"""% of the traced window's device-idle time during which the host was
innermost in the program's ``train.optimizer`` span (the optimizer's step)."""
from portbench import spans


def read(prof):
    return spans.idle_share(prof, ("train.optimizer",))
