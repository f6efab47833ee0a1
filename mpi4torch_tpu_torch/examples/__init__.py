"""Torch versions of the mpi4torch reference's examples (the repository's
BASELINE configs 1, 3 and 5): ``simple_linear_regression``,
``isend_recv_wait`` and ``halo_exchange_stencil``.  Each runs as
``python -m mpi4torch_tpu_torch.examples.<name> [nranks] [--cpu]``, on the
CUDA device unless ``--cpu`` is given, and checks its own results."""
