"""One per-layer metric per file: ``read(v)`` takes the run's view (the
driver's ``layer_view``) and returns the metric's value, or None when the
run holds nothing to read it from (the harness then leaves it out)."""
