"""Data parallelism over ``torch.distributed``; counterpart of ``nerf_tpu/parallel``.

``mesh``: the process group (NCCL on CUDA, gloo on the CPU) as the 1-D
``data`` mesh, the batch split, broadcasts, the gradient all-reduce and a
launcher of ranks; ``multihost``: rank-0 gating, barriers, broadcasts and
gathers; ``train_step``: the data-parallel train step; ``kilonerf_ep``:
KiloNeRF's networks sharded over the ranks, points exchanged with
all-to-all; ``dryrun``: the 1-vs-N checks.
"""
