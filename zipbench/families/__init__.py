"""One module per published ``model_type``, found by that name
(``zipbench/families/<model_type>.py``):

* ``fields(c) -> dict``: the port's ``ModelConfig`` fields for configuration
  file ``c`` (its published keys); ``ValueError`` on any value the port
  cannot run, so a file never claims a mechanism the run leaves out;
* ``REFERENCE``: the module of ``zipbench/reference/`` whose
  ``logits(params, hp, tokens, prec)`` is the family's plain float32
  reference (``hp.published`` holds the file's own keys);
* optionally ``leaf_rule(path, t, gen) -> Tensor | None``: the values of a
  parameter leaf that ``weights.py``'s common rules do not cover, drawn
  from ``gen`` (None: no rule for that leaf).
"""
