"""The generators. A mix (``traffic/<mix>.json``) names one by its
``kind``; each is a ``Driver`` class (see ``benchmark.harness``)."""
