"""One reader a metric: ``<metric>.py`` holds ``read(run)``, which takes
the metric from the run (``run.Run``: the window's host clock, the
records' counts, the trace of the traced calls) and returns its value, or
None where it finds nothing to read."""
