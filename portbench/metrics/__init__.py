"""One reader a per-layer metric, ``<metric name>.py``: ``LAYER``, ``UNIT``,
``MOVES``, ``KINDS`` (the traffic kinds it reads) and ``read(view)``, which
returns the value or None where the run holds nothing to read."""
