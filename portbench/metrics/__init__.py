"""Per-layer metric readers: ``<name>.py`` holds ``read(ctx)``, which
returns the metric's value from the traced run's spans, counters and
device trace (``ctx``: see ``run.Context``), or None when it finds
nothing to read; the harness then leaves the metric out."""
