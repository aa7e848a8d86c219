"""The ``ikflow-torch`` command line (``cli/main.py``)."""
