"""% of the traced window's device-idle time during which the host was
innermost in ``mlp.pack`` (the MLP's weights packed for the kernels) or
``mlp.unpack_grads`` (their gradients put back in the tree's layout)."""
from portbench import spans


def read(prof):
    return spans.idle_share(prof, ("mlp.pack", "mlp.unpack_grads"))
