"""PyTorch/CUDA port of the jepsen-tpu history checkers.

The queue checkers (total-queue and per-value queue linearizability) run
on ``[B, L]`` torch tensors.  Their per-value statistics come from one
hand-written CUDA kernel (``csrc/queue_stats.cu``) on a CUDA tensor, and
from its plain PyTorch version on a CPU tensor.

Entry points take ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run the plain versions.  Importing this
package initializes no CUDA context and builds nothing: the kernel is
compiled at its first launch.

The package imports torch, numpy and the standard library only.
"""
