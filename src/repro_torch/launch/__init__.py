"""Entry points of the port's LM side (``serve``)."""
