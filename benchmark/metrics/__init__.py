"""One reader a metric: ``metrics/<name>.py``, or
``metrics/<name before the first dot>.py`` for a metric split by cell
(``attn_roofline.lm``, ``attn_roofline.vit``).  ``read(run)`` returns the
value, or None when the run holds nothing to read, and the harness then
leaves the metric out.  ``run`` carries ``work`` (what a step completes),
``model_flops``, ``attention_calls``, ``peaks``, ``setup_s``, ``window``
(``steps``, ``seconds``, ``step_s``) and, in a traced run, ``trace`` (the
profiled stretch as :func:`benchmark.trace_reduce.reduce` gives it, with
``comm_s``: rank 0's host seconds in communication, and ``steps``)."""
