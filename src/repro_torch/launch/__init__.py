"""Entry points of the port's LM scaffold (``serve``)."""
