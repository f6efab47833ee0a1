"""Plain float32 PyTorch references, one module per model family, written
from the published descriptions and independent of the port: they import
nothing of ``mpi4torch_tpu_torch`` or the JAX package and take nothing the
port made.  Each module gives ``loss_sum(conf, P, rows, mm)``: the summed
loss of a block of one rank's rows under parameters ``P`` (a dict from a
leaf's path to its tensor, in the port's layout), with every product of a
weight matrix taken by ``mm``.  :mod:`.common` drives the training steps.
"""
