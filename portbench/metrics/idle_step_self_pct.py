"""% of the traced window's device-idle time during which the host was in
``train.step`` and in none of its child spans: the step's own host code
(the ray batch, the loss, autograd, the kernels' launches)."""
from portbench import spans


def read(prof):
    return spans.idle_share(prof, ("train.step",))
