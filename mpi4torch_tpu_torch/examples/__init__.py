"""Torch versions of the mpi4torch reference's examples (the repository's
BASELINE configs 1, 3 and 5): ``simple_linear_regression``,
``isend_recv_wait`` and ``halo_exchange_stencil``; and of the JAX
package's strategy examples: ``ring_attention_longcontext``,
``expert_parallel_moe``, ``tensor_parallel_mlp``,
``compressed_data_parallel``, ``resnet_cifar_dp`` (BASELINE config 4),
``vit_patch_parallel``, ``pipeline_training``, ``generate_kv_cache``,
``zero_sharded_optimizer`` and ``checkpoint_resume``.  Each runs as
``python -m mpi4torch_tpu_torch.examples.<name> [nranks] [--cpu]``, on the
CUDA device unless ``--cpu`` is given, and checks its own results."""
