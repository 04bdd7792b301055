"""One reader a metric, ``<metric>.py`` with ``read(run)``, found by the
metric's name (names may hold dots, so the harness loads them by path). A
reader that finds nothing to read returns None."""
