"""One way of driving the port per file: a ``Driver(run)`` with ``serve()``
(set-up, warm-up, the window, the drain), ``layer_view(trace)``, ``free()``
and ``check()`` (the correctness numbers, each with its limit)."""
