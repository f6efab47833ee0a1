"""Model families: one module each, named by a configuration's ``family``.

A family module gives the harness what it needs of one kind of model:

* ``port_config(conf)`` — the port's configuration object;
* ``param_specs(conf)`` — ``[(path, shape, init, scale)]`` of every leaf
  in the port's parameter layout (``init`` is ``"normal"``, ``"ones"`` or
  ``"zeros"``);
* ``make_inputs(conf, traffic, generator, device, n_steps)`` — the inputs
  of ``n_steps`` steps for every rank, drawn from ``generator``;
* ``batch(inputs, step, rank)`` — one rank's batch of one step;
* ``train_step(comm, cfg, params, batch, lr)`` — the port's entry,
  returning ``(loss, new_params)``; ``comm`` None leaves the exchange out;
* ``work(conf, traffic)`` — what a step completes (``{"tokens": n}``);
* ``model_flops(conf, traffic)`` — the model's operations a step, all
  ranks, forward and backward, no recomputation;
* ``attention_calls(conf, traffic)`` — the attention launches a step, all
  ranks, as ``bounds.flash_attention`` takes them, each with a ``count``.
"""
