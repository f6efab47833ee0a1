"""The benchmark of the PyTorch/CUDA port (``mpi4torch_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix,
model family, loop, metric or kernel lives in a file of its own, found by
the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — the model's published sizes, as run;
* ``traffic/<traffic>.json`` — the parameters of the inputs and the loop;
* ``limits/<cell>.json`` — the limits of the numbers that decide ``correct``;
* ``models/<family>.py`` — the port's entry, the weights' layout and the
  model's operation count;
* ``reference/<family>.py`` — the plain float32 PyTorch model it is held to;
* ``loops/<loop>.py`` — the loop that drives the entry;
* ``metrics/<metric>.py`` (or ``metrics/<name before the first dot>.py``)
  — one reader per metric;
* ``bounds/<kernel family>.py`` — a kernel's operations and bytes.

Nothing here imports JAX or the JAX package.
"""
